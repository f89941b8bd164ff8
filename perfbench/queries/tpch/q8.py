"""TPC-H Q8, national market share (spec clause 2.4.8; validation
parameters: BRAZIL, AMERICA, ECONOMY ANODIZED STEEL). Eight tables."""
import numpy as np

from perfbench import reflib

ORDER_BY = [("o_year", True)]


def plan(sf):
    """The program's plan, a frozen copy of `tpch/queries.py::q8`."""
    import numpy as np
    from repro_torch.relational.expr import Func, between, case, col
    from repro_torch.relational.plan import GroupBy, Join, Project, Scan, Sort

    def year_of(e):
        return Func(lambda d: d.astype("datetime64[D]").astype(
            "datetime64[Y]").astype(np.int64) + 1970, e)

    part = Scan("part", filter=col("p_type") == "ECONOMY ANODIZED STEEL")
    li = Scan("lineitem")
    supp = Scan("supplier")
    orders = Scan("orders", filter=between(
        col("o_orderdate"), reflib.date("1995-01-01"),
        reflib.date("1996-12-31")))
    cust = Scan("customer")
    n1 = Scan("nation", alias="n1")
    reg = Scan("region", filter=col("r_name") == "AMERICA")
    n2 = Scan("nation", alias="n2")
    j = Join(li, part, ["l_partkey"], ["p_partkey"])
    j = Join(j, supp, ["l_suppkey"], ["s_suppkey"])
    j = Join(j, orders, ["l_orderkey"], ["o_orderkey"])
    j = Join(j, cust, ["o_custkey"], ["c_custkey"])
    j = Join(j, n1, ["c_nationkey"], ["n1_n_nationkey"])
    j = Join(j, reg, ["n1_n_regionkey"], ["r_regionkey"])
    j = Join(j, n2, ["s_nationkey"], ["n2_n_nationkey"])
    j = Project(j, {
        "o_year": year_of(col("o_orderdate")),
        "volume": col("l_extendedprice") * (1 - col("l_discount")),
        "brazil_volume": case(
            col("n2_n_name") == "BRAZIL",
            col("l_extendedprice") * (1 - col("l_discount")), 0.0)})
    g = GroupBy(j, ["o_year"], [("num", "sum", "brazil_volume"),
                                ("den", "sum", "volume")])
    g = Project(g, {"o_year": col("o_year"),
                    "mkt_share": col("num") / col("den")})
    return Sort(g, ORDER_BY)


def reference(db, acc):
    o, li, c, s, n, r, p = (db["orders"], db["lineitem"], db["customer"],
                            db["supplier"], db["nation"], db["region"],
                            db["part"])
    steel = reflib.eq(p["p_type"], "ECONOMY ANODIZED STEEL")
    pi = reflib.lookup(p["p_partkey"], li["l_partkey"])
    rows = np.flatnonzero(steel[pi])
    oi = reflib.lookup(o["o_orderkey"], li["l_orderkey"][rows])
    odate = o["o_orderdate"][oi]
    ci = reflib.lookup(c["c_custkey"], o["o_custkey"][oi])
    n1 = reflib.lookup(n["n_nationkey"], c["c_nationkey"][ci])
    america = r["r_regionkey"][reflib.eq(r["r_name"], "AMERICA")]
    keep = ((odate >= reflib.date("1995-01-01"))
            & (odate <= reflib.date("1996-12-31"))
            & np.isin(n["n_regionkey"][n1], america))
    rows, odate = rows[keep], odate[keep]
    sn = s["s_nationkey"][reflib.lookup(s["s_suppkey"], li["l_suppkey"][rows])]
    brazil = n["n_name"].decode()[reflib.lookup(n["n_nationkey"], sn)] \
        == "BRAZIL"
    vol = (reflib.measure(li["l_extendedprice"][rows], acc)
           * (1 - reflib.measure(li["l_discount"][rows], acc)))
    gid, (gy,) = reflib.group_by([reflib.year(odate)])
    num = reflib.group_sum(gid, len(gy), np.where(brazil, vol, 0), acc)
    den = reflib.group_sum(gid, len(gy), vol, acc)
    return reflib.order_by(reflib.answer({"o_year": gy,
                                          "mkt_share": num / den}), ORDER_BY)
