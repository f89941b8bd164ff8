"""TPC-H Q21, suppliers who kept orders waiting (spec clause 2.4.21;
validation parameter: SAUDI ARABIA). Two lineitem-wide COUNT(DISTINCT)
group-bys: an order with another supplier, and with no other late one."""
import numpy as np

from perfbench import reflib

ORDER_BY = [("numwait", False), ("s_name", True)]
LIMIT = 100


def plan(sf):
    """The program's plan, a frozen copy of `tpch/queries.py::q21`."""
    from repro_torch.relational.expr import col
    from repro_torch.relational.plan import (GroupBy, Join, Limit, Project,
                                             Scan, Sort, SubqueryScan)
    l2 = Scan("lineitem", alias="l2")
    g2 = Project(
        GroupBy(l2, ["l2_l_orderkey"], [("nsupp", "nunique", "l2_l_suppkey")],
                having=col("nsupp") >= 2),
        {"g2_orderkey": col("l2_l_orderkey")})
    l3 = Scan("lineitem", alias="l3",
              filter=col("l3_l_receiptdate") > col("l3_l_commitdate"))
    g3 = Project(
        GroupBy(l3, ["l3_l_orderkey"], [("nlate", "nunique", "l3_l_suppkey")],
                having=col("nlate") == 1),
        {"g3_orderkey": col("l3_l_orderkey")})
    li = Scan("lineitem", filter=col("l_receiptdate") > col("l_commitdate"))
    orders = Scan("orders", filter=col("o_orderstatus") == "F")
    supp = Scan("supplier")
    nat = Scan("nation", filter=col("n_name") == "SAUDI ARABIA")
    j = Join(li, orders, ["l_orderkey"], ["o_orderkey"])
    j = Join(j, supp, ["l_suppkey"], ["s_suppkey"])
    j = Join(j, nat, ["s_nationkey"], ["n_nationkey"])
    j = Join(j, SubqueryScan(g2, "multi_supp"), ["l_orderkey"],
             ["g2_orderkey"], how="semi")
    j = Join(j, SubqueryScan(g3, "one_late"), ["l_orderkey"],
             ["g3_orderkey"], how="semi")
    g = GroupBy(j, ["s_name"], [("numwait", "count", "")])
    return Limit(Sort(g, ORDER_BY), LIMIT)


def reference(db, acc):
    o, li, s, n = db["orders"], db["lineitem"], db["supplier"], db["nation"]
    ok, sk = li["l_orderkey"], li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    g, cnt = reflib.distinct_per_group(ok, sk)
    multi = g[cnt >= 2]
    g, cnt = reflib.distinct_per_group(ok[late], sk[late])
    one_late = g[cnt == 1]
    saudi = n["n_nationkey"][reflib.eq(n["n_name"], "SAUDI ARABIA")]
    si = reflib.lookup(s["s_suppkey"], sk)
    oi = reflib.lookup(o["o_orderkey"], ok)
    keep = (late & reflib.eq(o["o_orderstatus"], "F")[oi]
            & np.isin(s["s_nationkey"][si], saudi)
            & reflib.member(ok, multi) & reflib.member(ok, one_late))
    gid, (gs,) = reflib.group_by([si[keep]])
    return reflib.order_by(reflib.answer({
        "s_name": s["s_name"].decode()[gs],
        "numwait": np.bincount(gid, minlength=len(gs)).astype(np.int64)}),
        ORDER_BY, LIMIT)
