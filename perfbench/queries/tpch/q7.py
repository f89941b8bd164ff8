"""TPC-H Q7, volume shipping (spec clause 2.4.7; validation parameters:
FRANCE and GERMANY). Two aliases of nation."""
import numpy as np

from perfbench import reflib

ORDER_BY = [("supp_nation", True), ("cust_nation", True), ("l_year", True)]


def plan(sf):
    """The program's plan, a frozen copy of `tpch/queries.py::q7`."""
    import numpy as np
    from repro_torch.relational.expr import Func, between, col, isin
    from repro_torch.relational.plan import GroupBy, Join, Project, Scan, Sort

    def year_of(e):
        return Func(lambda d: d.astype("datetime64[D]").astype(
            "datetime64[Y]").astype(np.int64) + 1970, e)

    li = Scan("lineitem", filter=between(
        col("l_shipdate"), reflib.date("1995-01-01"),
        reflib.date("1996-12-31")))
    supp = Scan("supplier")
    orders = Scan("orders")
    cust = Scan("customer")
    n1 = Scan("nation", alias="n1",
              filter=isin(col("n1_n_name"), ["FRANCE", "GERMANY"]))
    n2 = Scan("nation", alias="n2",
              filter=isin(col("n2_n_name"), ["FRANCE", "GERMANY"]))
    j = Join(li, supp, ["l_suppkey"], ["s_suppkey"])
    j = Join(j, orders, ["l_orderkey"], ["o_orderkey"])
    j = Join(j, cust, ["o_custkey"], ["c_custkey"])
    j = Join(j, n1, ["s_nationkey"], ["n1_n_nationkey"])
    j = Join(j, n2, ["c_nationkey"], ["n2_n_nationkey"],
             extra=(((col("n1_n_name") == "FRANCE")
                     & (col("n2_n_name") == "GERMANY"))
                    | ((col("n1_n_name") == "GERMANY")
                       & (col("n2_n_name") == "FRANCE"))))
    j = Project(j, {
        "supp_nation": col("n1_n_name"),
        "cust_nation": col("n2_n_name"),
        "l_year": year_of(col("l_shipdate")),
        "volume": col("l_extendedprice") * (1 - col("l_discount"))})
    g = GroupBy(j, ["supp_nation", "cust_nation", "l_year"],
                [("revenue", "sum", "volume")])
    return Sort(g, ORDER_BY)


def reference(db, acc):
    o, li, c, s, n = (db["orders"], db["lineitem"], db["customer"],
                      db["supplier"], db["nation"])
    names = n["n_name"].decode()
    ship = li["l_shipdate"]
    keep = (ship >= reflib.date("1995-01-01")) & \
        (ship <= reflib.date("1996-12-31"))
    li_rows = np.flatnonzero(keep)
    sn = s["s_nationkey"][reflib.lookup(s["s_suppkey"],
                                        li["l_suppkey"][li_rows])]
    oi = reflib.lookup(o["o_orderkey"], li["l_orderkey"][li_rows])
    cn = c["c_nationkey"][reflib.lookup(c["c_custkey"], o["o_custkey"][oi])]
    s_name = names[reflib.lookup(n["n_nationkey"], sn)]
    c_name = names[reflib.lookup(n["n_nationkey"], cn)]
    pair = (((s_name == "FRANCE") & (c_name == "GERMANY"))
            | ((s_name == "GERMANY") & (c_name == "FRANCE")))
    rows = li_rows[pair]
    vol = (reflib.measure(li["l_extendedprice"][rows], acc)
           * (1 - reflib.measure(li["l_discount"][rows], acc)))
    sk = reflib.lookup(n["n_nationkey"], sn[pair])
    ck = reflib.lookup(n["n_nationkey"], cn[pair])
    gid, (gs, gc, gy) = reflib.group_by([sk, ck, reflib.year(ship[rows])])
    return reflib.order_by(reflib.answer({
        "supp_nation": names[gs], "cust_nation": names[gc], "l_year": gy,
        "revenue": reflib.group_sum(gid, len(gs), vol, acc)}), ORDER_BY)
