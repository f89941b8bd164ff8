"""TPC-H Q18, large volume customers (spec clause 2.4.18; validation
parameter: 300). A lineitem-wide group-by (quantity per order) joined
back to orders, customer and lineitem."""
import numpy as np

from perfbench import reflib

ORDER_BY = [("o_totalprice", False), ("o_orderdate", True)]
LIMIT = 100


def plan(sf):
    """The program's plan, a frozen copy of `tpch/queries.py::q18`."""
    from repro_torch.relational.expr import col
    from repro_torch.relational.plan import (GroupBy, Join, Limit, Project,
                                             Scan, Sort, SubqueryScan)
    li_sub = Scan("lineitem", alias="ls")
    big = Project(
        GroupBy(li_sub, ["ls_l_orderkey"], [("qty", "sum", "ls_l_quantity")],
                having=col("qty") > 300),
        {"big_orderkey": col("ls_l_orderkey")})
    sub = SubqueryScan(big, "bigorders")
    cust = Scan("customer")
    orders = Scan("orders")
    li = Scan("lineitem")
    j = Join(orders, sub, ["o_orderkey"], ["big_orderkey"])
    j = Join(j, cust, ["o_custkey"], ["c_custkey"])
    j = Join(li, j, ["l_orderkey"], ["o_orderkey"])
    g = GroupBy(j, ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                    "o_totalprice"], [("sum_qty", "sum", "l_quantity")])
    return Limit(Sort(g, ORDER_BY), LIMIT)


def reference(db, acc):
    o, li, c = db["orders"], db["lineitem"], db["customer"]
    ok = li["l_orderkey"]
    gid, (orders,) = reflib.group_by([ok])
    qty = reflib.group_sum(gid, len(orders), li["l_quantity"], acc)
    big = orders[qty > 300]
    oi = reflib.lookup(o["o_orderkey"], big)
    ci = reflib.lookup(c["c_custkey"], o["o_custkey"][oi])
    return reflib.order_by(reflib.answer({
        "c_name": c["c_name"].decode()[ci], "c_custkey": c["c_custkey"][ci],
        "o_orderkey": big, "o_orderdate": o["o_orderdate"][oi],
        "o_totalprice": o["o_totalprice"][oi],
        "sum_qty": qty[qty > 300]}), ORDER_BY, LIMIT)
