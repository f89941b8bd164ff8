"""TPC-H Q5, local supplier volume (spec clause 2.4.5; validation
parameters: region ASIA, date 1994-01-01). Cyclic join graph: the
customer and the supplier share a nation."""
import numpy as np

from perfbench import reflib

ORDER_BY = [("revenue", False)]


def plan(sf):
    """The program's plan, a frozen copy of `tpch/queries.py::q5`."""
    from repro_torch.relational.expr import col
    from repro_torch.relational.plan import GroupBy, Join, Project, Scan, Sort
    lo, hi = reflib.date("1994-01-01"), reflib.date("1995-01-01")
    cust = Scan("customer")
    orders = Scan("orders", filter=(col("o_orderdate") >= lo)
                  & (col("o_orderdate") < hi))
    li = Scan("lineitem")
    supp = Scan("supplier")
    nat = Scan("nation")
    reg = Scan("region", filter=col("r_name") == "ASIA")
    j = Join(orders, cust, ["o_custkey"], ["c_custkey"])
    j = Join(li, j, ["l_orderkey"], ["o_orderkey"])
    j = Join(j, supp, ["l_suppkey", "c_nationkey"],
             ["s_suppkey", "s_nationkey"])
    j = Join(j, nat, ["s_nationkey"], ["n_nationkey"])
    j = Join(j, reg, ["n_regionkey"], ["r_regionkey"])
    j = Project(j, {"n_name": col("n_name"),
                    "rev": col("l_extendedprice") * (1 - col("l_discount"))})
    g = GroupBy(j, ["n_name"], [("revenue", "sum", "rev")])
    return Sort(g, ORDER_BY)


def reference(db, acc):
    o, li, c, s = db["orders"], db["lineitem"], db["customer"], db["supplier"]
    n, r = db["nation"], db["region"]
    lo, hi = reflib.date("1994-01-01"), reflib.date("1995-01-01")
    oi = reflib.lookup(o["o_orderkey"], li["l_orderkey"])
    odate = o["o_orderdate"][oi]
    ci = reflib.lookup(c["c_custkey"], o["o_custkey"][oi])
    si = reflib.lookup(s["s_suppkey"], li["l_suppkey"])
    snat = s["s_nationkey"][si]
    asia = r["r_regionkey"][reflib.eq(r["r_name"], "ASIA")]
    ni = reflib.lookup(n["n_nationkey"], snat)
    keep = ((odate >= lo) & (odate < hi)
            & (c["c_nationkey"][ci] == snat)
            & np.isin(n["n_regionkey"][ni], asia))
    rev = (reflib.measure(li["l_extendedprice"][keep], acc)
           * (1 - reflib.measure(li["l_discount"][keep], acc)))
    gid, (nk,) = reflib.group_by([ni[keep]])
    return reflib.order_by(reflib.answer({
        "n_name": n["n_name"].decode()[nk],
        "revenue": reflib.group_sum(gid, len(nk), rev, acc)}), ORDER_BY)
