"""TPC-H Q10, returned items (spec clause 2.4.10; validation parameter:
1993-10-01). The 20 customers who returned the most."""
import numpy as np

from perfbench import reflib

ORDER_BY = [("revenue", False)]
LIMIT = 20


def plan(sf):
    """The program's plan, a frozen copy of `tpch/queries.py::q10`."""
    from repro_torch.relational.expr import col
    from repro_torch.relational.plan import (GroupBy, Join, Limit, Project,
                                             Scan, Sort)
    lo, hi = reflib.date("1993-10-01"), reflib.date("1994-01-01")
    cust = Scan("customer")
    orders = Scan("orders", filter=(col("o_orderdate") >= lo)
                  & (col("o_orderdate") < hi))
    li = Scan("lineitem", filter=col("l_returnflag") == "R")
    nat = Scan("nation")
    j = Join(orders, cust, ["o_custkey"], ["c_custkey"])
    j = Join(li, j, ["l_orderkey"], ["o_orderkey"])
    j = Join(j, nat, ["c_nationkey"], ["n_nationkey"])
    keys = ["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
            "c_address"]
    j = Project(j, {**{k: col(k) for k in keys},
                    "rev": col("l_extendedprice") * (1 - col("l_discount"))})
    g = GroupBy(j, keys, [("revenue", "sum", "rev")])
    return Limit(Sort(g, ORDER_BY), LIMIT)


def reference(db, acc):
    o, li, c, n = db["orders"], db["lineitem"], db["customer"], db["nation"]
    lo, hi = reflib.date("1993-10-01"), reflib.date("1994-01-01")
    rows = np.flatnonzero(reflib.eq(li["l_returnflag"], "R"))
    oi = reflib.lookup(o["o_orderkey"], li["l_orderkey"][rows])
    odate = o["o_orderdate"][oi]
    keep = (odate >= lo) & (odate < hi)
    rows, oi = rows[keep], oi[keep]
    ci = reflib.lookup(c["c_custkey"], o["o_custkey"][oi])
    rev = (reflib.measure(li["l_extendedprice"][rows], acc)
           * (1 - reflib.measure(li["l_discount"][rows], acc)))
    gid, (gc,) = reflib.group_by([ci])
    ni = reflib.lookup(n["n_nationkey"], c["c_nationkey"][gc])
    return reflib.order_by(reflib.answer({
        "c_custkey": c["c_custkey"][gc], "c_name": c["c_name"].decode()[gc],
        "c_acctbal": c["c_acctbal"][gc], "c_phone": c["c_phone"].decode()[gc],
        "n_name": n["n_name"].decode()[ni],
        "c_address": c["c_address"].decode()[gc],
        "revenue": reflib.group_sum(gid, len(gc), rev, acc)}),
        ORDER_BY, LIMIT)
