"""TPC-H Q9, product type profit (spec clause 2.4.9; validation
parameter: green). Cyclic through partsupp: a lineitem's (partkey,
suppkey) joins partsupp."""
import numpy as np

from perfbench import reflib

ORDER_BY = [("nation", True), ("o_year", False)]


def plan(sf):
    """The program's plan, a frozen copy of `tpch/queries.py::q9`."""
    import numpy as np
    from repro_torch.relational.expr import Func, col, like
    from repro_torch.relational.plan import GroupBy, Join, Project, Scan, Sort

    def year_of(e):
        return Func(lambda d: d.astype("datetime64[D]").astype(
            "datetime64[Y]").astype(np.int64) + 1970, e)

    part = Scan("part", filter=like(col("p_name"), "%green%"))
    li = Scan("lineitem")
    supp = Scan("supplier")
    ps = Scan("partsupp")
    orders = Scan("orders")
    nat = Scan("nation")
    j = Join(li, part, ["l_partkey"], ["p_partkey"])
    j = Join(j, supp, ["l_suppkey"], ["s_suppkey"])
    j = Join(j, ps, ["l_partkey", "l_suppkey"], ["ps_partkey", "ps_suppkey"])
    j = Join(j, orders, ["l_orderkey"], ["o_orderkey"])
    j = Join(j, nat, ["s_nationkey"], ["n_nationkey"])
    j = Project(j, {
        "nation": col("n_name"),
        "o_year": year_of(col("o_orderdate")),
        "amount": col("l_extendedprice") * (1 - col("l_discount"))
        - col("ps_supplycost") * col("l_quantity")})
    g = GroupBy(j, ["nation", "o_year"], [("sum_profit", "sum", "amount")])
    return Sort(g, ORDER_BY)


def reference(db, acc):
    o, li, s, n, p, ps = (db["orders"], db["lineitem"], db["supplier"],
                          db["nation"], db["part"], db["partsupp"])
    green = reflib.contains(p["p_name"], "green")
    rows = np.flatnonzero(green[reflib.lookup(p["p_partkey"],
                                              li["l_partkey"])])
    psi = reflib.lookup(reflib.pair_key(ps["ps_partkey"], ps["ps_suppkey"]),
                        reflib.pair_key(li["l_partkey"][rows],
                                        li["l_suppkey"][rows]))
    sn = s["s_nationkey"][reflib.lookup(s["s_suppkey"], li["l_suppkey"][rows])]
    ni = reflib.lookup(n["n_nationkey"], sn)
    odate = o["o_orderdate"][reflib.lookup(o["o_orderkey"],
                                           li["l_orderkey"][rows])]
    amount = (reflib.measure(li["l_extendedprice"][rows], acc)
              * (1 - reflib.measure(li["l_discount"][rows], acc))
              - reflib.measure(ps["ps_supplycost"][psi], acc)
              * reflib.measure(li["l_quantity"][rows], acc))
    gid, (gn, gy) = reflib.group_by([ni, reflib.year(odate)])
    return reflib.order_by(reflib.answer({
        "nation": n["n_name"].decode()[gn], "o_year": gy,
        "sum_profit": reflib.group_sum(gid, len(gn), amount, acc)}),
        ORDER_BY)
