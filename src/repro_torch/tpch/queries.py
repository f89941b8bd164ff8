"""The 20 TPC-H join queries (Q1 and Q6 have no joins; excluded, as in the
paper) expressed in the plan IR with spec-default substitution parameters.

Each query function returns a PlanNode; `build_query(n, sf)` dispatches. Plans
push local predicates into Scan leaves (the paper's No-Pred-Trans baseline
already has predicate pushdown) and express subqueries with SubqueryScan
(vertex in the outer transfer graph, §3.4) or Bind (scalar subquery,
executed with its own transfer phase).

Join node convention: Join(left=probe/outer, right=build/inner).
"""
from __future__ import annotations

import numpy as np

from repro_torch.relational.expr import (
    CaseWhen, Col, Func, between, case, col, dict_map, isin, like, lit,
    not_like, substring,
)
from repro_torch.relational.plan import (
    Bind, Filter, GroupBy, Join, Limit, PlanNode, Project, Scan, Sort,
    SubqueryScan,
)
from repro_torch.tpch.gen import date


def year_of(e) -> Func:
    """Extract calendar year from an epoch-day int column."""
    return Func(lambda d: d.astype("datetime64[D]").astype(
        "datetime64[Y]").astype(np.int64) + 1970, e)


def _passthrough(*names):
    return {n: col(n) for n in names}


# ---------------------------------------------------------------------------
# Q2 — minimum-cost supplier (9 relations; paper's best case, 45x)
# ---------------------------------------------------------------------------

def q2(sf: float) -> PlanNode:
    def europe_chain(tag: str):
        supp = Scan("supplier", alias=f"s{tag}")
        nat = Scan("nation", alias=f"n{tag}")
        reg = Scan("region", alias=f"r{tag}",
                   filter=col(f"r{tag}_r_name") == "EUROPE")
        sn = Join(supp, nat, [f"s{tag}_s_nationkey"], [f"n{tag}_n_nationkey"])
        return Join(sn, reg, [f"n{tag}_n_regionkey"], [f"r{tag}_r_regionkey"])

    # scalar-per-partkey subquery: min supplycost within EUROPE
    ps2 = Scan("partsupp", alias="ps2")
    sub_join = Join(ps2, europe_chain("2"),
                    ["ps2_ps_suppkey"], ["s2_s_suppkey"])
    sub = Project(
        GroupBy(sub_join, ["ps2_ps_partkey"],
                [("min_cost", "min", "ps2_ps_supplycost")]),
        {"sub_partkey": col("ps2_ps_partkey"), "min_cost": col("min_cost")})
    sub_scan = SubqueryScan(sub, "mincost")

    part = Scan("part", filter=(col("p_size") == 15)
                & like(col("p_type"), "%BRASS"))
    ps = Scan("partsupp")
    pps = Join(ps, part, ["ps_partkey"], ["p_partkey"])
    j = Join(pps, europe_chain(""), ["ps_suppkey"], ["s_s_suppkey"])
    j = Join(j, sub_scan, ["ps_partkey"], ["sub_partkey"],
             extra=col("ps_supplycost") == col("min_cost"))
    out = Project(j, _passthrough(
        "s_s_acctbal", "s_s_name", "n_n_name", "p_partkey", "p_mfgr"))
    out = Sort(out, [("s_s_acctbal", False), ("n_n_name", True),
                     ("s_s_name", True), ("p_partkey", True)])
    return Limit(out, 100)


# ---------------------------------------------------------------------------
# Q3 — shipping priority
# ---------------------------------------------------------------------------

def q3(sf: float) -> PlanNode:
    cutoff = date("1995-03-15")
    cust = Scan("customer", filter=col("c_mktsegment") == "BUILDING")
    orders = Scan("orders", filter=col("o_orderdate") < cutoff)
    li = Scan("lineitem", filter=col("l_shipdate") > cutoff)
    j = Join(orders, cust, ["o_custkey"], ["c_custkey"])
    j = Join(li, j, ["l_orderkey"], ["o_orderkey"])
    j = Project(j, {
        "l_orderkey": col("l_orderkey"),
        "o_orderdate": col("o_orderdate"),
        "o_shippriority": col("o_shippriority"),
        "rev": col("l_extendedprice") * (1 - col("l_discount")),
    })
    g = GroupBy(j, ["l_orderkey", "o_orderdate", "o_shippriority"],
                [("revenue", "sum", "rev")])
    return Limit(Sort(g, [("revenue", False), ("o_orderdate", True)]), 10)


# ---------------------------------------------------------------------------
# Q4 — order priority checking (semi-join)
# ---------------------------------------------------------------------------

def q4(sf: float) -> PlanNode:
    lo, hi = date("1993-07-01"), date("1993-10-01")
    orders = Scan("orders", filter=(col("o_orderdate") >= lo)
                  & (col("o_orderdate") < hi))
    li = Scan("lineitem", filter=col("l_commitdate") < col("l_receiptdate"))
    j = Join(orders, li, ["o_orderkey"], ["l_orderkey"], how="semi")
    g = GroupBy(j, ["o_orderpriority"], [("order_count", "count", "")])
    return Sort(g, [("o_orderpriority", True)])


# ---------------------------------------------------------------------------
# Q5 — local supplier volume (the paper's running example; cyclic)
# ---------------------------------------------------------------------------

def q5(sf: float, join_order: int = 0) -> PlanNode:
    lo, hi = date("1994-01-01"), date("1995-01-01")
    cust = Scan("customer")
    orders = Scan("orders", filter=(col("o_orderdate") >= lo)
                  & (col("o_orderdate") < hi))
    li = Scan("lineitem")
    supp = Scan("supplier")
    nat = Scan("nation")
    reg = Scan("region", filter=col("r_name") == "ASIA")

    if join_order == 0:
        j = Join(orders, cust, ["o_custkey"], ["c_custkey"])
        j = Join(li, j, ["l_orderkey"], ["o_orderkey"])
        j = Join(j, supp, ["l_suppkey", "c_nationkey"],
                 ["s_suppkey", "s_nationkey"])
        j = Join(j, nat, ["s_nationkey"], ["n_nationkey"])
        j = Join(j, reg, ["n_regionkey"], ["r_regionkey"])
    elif join_order == 1:
        # start from the selective region->nation side
        j = Join(nat, reg, ["n_regionkey"], ["r_regionkey"])
        j = Join(supp, j, ["s_nationkey"], ["n_nationkey"])
        j = Join(li, j, ["l_suppkey"], ["s_suppkey"])
        j = Join(j, orders, ["l_orderkey"], ["o_orderkey"])
        j = Join(j, cust, ["o_custkey", "s_nationkey"],
                 ["c_custkey", "c_nationkey"])
    elif join_order == 2:
        # fact-table first (adversarial order)
        j = Join(li, orders, ["l_orderkey"], ["o_orderkey"])
        j = Join(j, cust, ["o_custkey"], ["c_custkey"])
        j = Join(j, supp, ["l_suppkey", "c_nationkey"],
                 ["s_suppkey", "s_nationkey"])
        j = Join(j, nat, ["s_nationkey"], ["n_nationkey"])
        j = Join(j, reg, ["n_regionkey"], ["r_regionkey"])
    else:
        # many-to-many hub first (worst case): customer x supplier per
        # nation, cross products that only collapse once lineitem and
        # orders finally link the two sides
        j = Join(cust, nat, ["c_nationkey"], ["n_nationkey"])
        j = Join(j, supp, ["n_nationkey"], ["s_nationkey"])
        j = Join(j, li, ["s_suppkey"], ["l_suppkey"])
        j = Join(j, orders, ["l_orderkey", "c_custkey"],
                 ["o_orderkey", "o_custkey"])
        j = Join(j, reg, ["n_regionkey"], ["r_regionkey"])

    j = Project(j, {
        "n_name": col("n_name"),
        "rev": col("l_extendedprice") * (1 - col("l_discount")),
    })
    g = GroupBy(j, ["n_name"], [("revenue", "sum", "rev")])
    return Sort(g, [("revenue", False)])


# ---------------------------------------------------------------------------
# Q7 — volume shipping (two nation aliases)
# ---------------------------------------------------------------------------

def q7(sf: float) -> PlanNode:
    li = Scan("lineitem",
              filter=between(col("l_shipdate"),
                             date("1995-01-01"), date("1996-12-31")))
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
        "volume": col("l_extendedprice") * (1 - col("l_discount")),
    })
    g = GroupBy(j, ["supp_nation", "cust_nation", "l_year"],
                [("revenue", "sum", "volume")])
    return Sort(g, [("supp_nation", True), ("cust_nation", True),
                    ("l_year", True)])


# ---------------------------------------------------------------------------
# Q8 — national market share
# ---------------------------------------------------------------------------

def q8(sf: float) -> PlanNode:
    part = Scan("part", filter=col("p_type") == "ECONOMY ANODIZED STEEL")
    li = Scan("lineitem")
    supp = Scan("supplier")
    orders = Scan("orders", filter=between(
        col("o_orderdate"), date("1995-01-01"), date("1996-12-31")))
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
            col("l_extendedprice") * (1 - col("l_discount")), 0.0),
    })
    g = GroupBy(j, ["o_year"], [("num", "sum", "brazil_volume"),
                                ("den", "sum", "volume")])
    g = Project(g, {"o_year": col("o_year"),
                    "mkt_share": col("num") / col("den")})
    return Sort(g, [("o_year", True)])


# ---------------------------------------------------------------------------
# Q9 — product type profit (cyclic: lineitem-part-partsupp-supplier)
# ---------------------------------------------------------------------------

def q9(sf: float) -> PlanNode:
    part = Scan("part", filter=like(col("p_name"), "%green%"))
    li = Scan("lineitem")
    supp = Scan("supplier")
    ps = Scan("partsupp")
    orders = Scan("orders")
    nat = Scan("nation")
    j = Join(li, part, ["l_partkey"], ["p_partkey"])
    j = Join(j, supp, ["l_suppkey"], ["s_suppkey"])
    j = Join(j, ps, ["l_partkey", "l_suppkey"],
             ["ps_partkey", "ps_suppkey"])
    j = Join(j, orders, ["l_orderkey"], ["o_orderkey"])
    j = Join(j, nat, ["s_nationkey"], ["n_nationkey"])
    j = Project(j, {
        "nation": col("n_name"),
        "o_year": year_of(col("o_orderdate")),
        "amount": col("l_extendedprice") * (1 - col("l_discount"))
        - col("ps_supplycost") * col("l_quantity"),
    })
    g = GroupBy(j, ["nation", "o_year"], [("sum_profit", "sum", "amount")])
    return Sort(g, [("nation", True), ("o_year", False)])


# ---------------------------------------------------------------------------
# Q10 — returned items
# ---------------------------------------------------------------------------

def q10(sf: float) -> PlanNode:
    lo, hi = date("1993-10-01"), date("1994-01-01")
    cust = Scan("customer")
    orders = Scan("orders", filter=(col("o_orderdate") >= lo)
                  & (col("o_orderdate") < hi))
    li = Scan("lineitem", filter=col("l_returnflag") == "R")
    nat = Scan("nation")
    j = Join(orders, cust, ["o_custkey"], ["c_custkey"])
    j = Join(li, j, ["l_orderkey"], ["o_orderkey"])
    j = Join(j, nat, ["c_nationkey"], ["n_nationkey"])
    j = Project(j, {
        **_passthrough("c_custkey", "c_name", "c_acctbal", "c_phone",
                       "n_name", "c_address"),
        "rev": col("l_extendedprice") * (1 - col("l_discount")),
    })
    g = GroupBy(j, ["c_custkey", "c_name", "c_acctbal", "c_phone",
                    "n_name", "c_address"],
                [("revenue", "sum", "rev")])
    return Limit(Sort(g, [("revenue", False)]), 20)


# ---------------------------------------------------------------------------
# Q11 — important stock identification (scalar subquery)
# ---------------------------------------------------------------------------

def q11(sf: float) -> PlanNode:
    def germany_ps(tag: str):
        ps = Scan("partsupp", alias=f"ps{tag}")
        supp = Scan("supplier", alias=f"s{tag}")
        nat = Scan("nation", alias=f"n{tag}",
                   filter=col(f"n{tag}_n_name") == "GERMANY")
        j = Join(ps, supp, [f"ps{tag}_ps_suppkey"], [f"s{tag}_s_suppkey"])
        j = Join(j, nat, [f"s{tag}_s_nationkey"], [f"n{tag}_n_nationkey"])
        return Project(j, {
            f"ps{tag}_ps_partkey": col(f"ps{tag}_ps_partkey"),
            "value": col(f"ps{tag}_ps_supplycost")
            * col(f"ps{tag}_ps_availqty"),
        })

    g = GroupBy(germany_ps(""), ["ps_ps_partkey"],
                [("value", "sum", "value")])
    total = GroupBy(germany_ps("2"), [], [("total", "sum", "value")])
    bound = Bind(g, "total", total, "total")
    frac = 0.0001 / max(sf, 1e-9)
    out = Filter(bound, col("value") > col("total") * frac)
    out = Project(out, {"ps_partkey": col("ps_ps_partkey"),
                        "value": col("value")})
    return Sort(out, [("value", False)])


# ---------------------------------------------------------------------------
# Q12 — shipping modes and order priority
# ---------------------------------------------------------------------------

def q12(sf: float) -> PlanNode:
    lo, hi = date("1994-01-01"), date("1995-01-01")
    li = Scan("lineitem", filter=(
        isin(col("l_shipmode"), ["MAIL", "SHIP"])
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= lo) & (col("l_receiptdate") < hi)))
    orders = Scan("orders")
    j = Join(li, orders, ["l_orderkey"], ["o_orderkey"])
    j = Project(j, {
        "l_shipmode": col("l_shipmode"),
        "high": case(isin(col("o_orderpriority"), ["1-URGENT", "2-HIGH"]),
                     1, 0),
        "low": case(isin(col("o_orderpriority"), ["1-URGENT", "2-HIGH"]),
                    0, 1),
    })
    g = GroupBy(j, ["l_shipmode"], [("high_line_count", "sum", "high"),
                                    ("low_line_count", "sum", "low")])
    return Sort(g, [("l_shipmode", True)])


# ---------------------------------------------------------------------------
# Q13 — customer distribution (left outer join)
# ---------------------------------------------------------------------------

def q13(sf: float) -> PlanNode:
    cust = Scan("customer")
    orders = Scan("orders",
                  filter=not_like(col("o_comment"), "%special%requests%"))
    j = Join(cust, orders, ["c_custkey"], ["o_custkey"], how="left")
    g1 = GroupBy(j, ["c_custkey"], [("c_count", "countv", "o_orderkey")])
    g2 = GroupBy(g1, ["c_count"], [("custdist", "count", "")])
    return Sort(g2, [("custdist", False), ("c_count", False)])


# ---------------------------------------------------------------------------
# Q14 — promotion effect
# ---------------------------------------------------------------------------

def q14(sf: float) -> PlanNode:
    lo, hi = date("1995-09-01"), date("1995-10-01")
    li = Scan("lineitem", filter=(col("l_shipdate") >= lo)
              & (col("l_shipdate") < hi))
    part = Scan("part")
    j = Join(li, part, ["l_partkey"], ["p_partkey"])
    j = Project(j, {
        "vol": col("l_extendedprice") * (1 - col("l_discount")),
        "promo": CaseWhen(
            like(col("p_type"), "PROMO%"),
            col("l_extendedprice") * (1 - col("l_discount")), lit(0.0)),
    })
    g = GroupBy(j, [], [("num", "sum", "promo"), ("den", "sum", "vol")])
    return Project(g, {"promo_revenue":
                       lit(100.0) * col("num") / col("den")})


# ---------------------------------------------------------------------------
# Q15 — top supplier (view + scalar max)
# ---------------------------------------------------------------------------

def _revenue_view() -> PlanNode:
    lo, hi = date("1996-01-01"), date("1996-04-01")
    li = Scan("lineitem", filter=(col("l_shipdate") >= lo)
              & (col("l_shipdate") < hi))
    li = Project(li, {
        "l_suppkey": col("l_suppkey"),
        "rev": col("l_extendedprice") * (1 - col("l_discount")),
    })
    return Project(
        GroupBy(li, ["l_suppkey"], [("total_revenue", "sum", "rev")]),
        {"supplier_no": col("l_suppkey"),
         "total_revenue": col("total_revenue")})


def q15(sf: float) -> PlanNode:
    rev = SubqueryScan(_revenue_view(), "revenue0")
    supp = Scan("supplier")
    j = Join(supp, rev, ["s_suppkey"], ["supplier_no"])
    mx = GroupBy(_revenue_view(), [], [("max_rev", "max", "total_revenue")])
    j = Bind(j, "max_rev", mx, "max_rev")
    j = Filter(j, col("total_revenue") == col("max_rev"))
    j = Project(j, _passthrough("s_suppkey", "s_name", "s_address",
                                "s_phone", "total_revenue"))
    return Sort(j, [("s_suppkey", True)])


# ---------------------------------------------------------------------------
# Q16 — parts/supplier relationship (anti join)
# ---------------------------------------------------------------------------

def q16(sf: float) -> PlanNode:
    part = Scan("part", filter=(
        (col("p_brand") != "Brand#45")
        & ~like(col("p_type"), "MEDIUM POLISHED%")
        & isin(col("p_size"), [49, 14, 23, 45, 19, 3, 36, 9])))
    ps = Scan("partsupp")
    complained = Scan(
        "supplier", alias="sc",
        filter=like(col("sc_s_comment"), "%Customer%Complaints%"))
    j = Join(ps, part, ["ps_partkey"], ["p_partkey"])
    j = Join(j, complained, ["ps_suppkey"], ["sc_s_suppkey"], how="anti")
    g = GroupBy(j, ["p_brand", "p_type", "p_size"],
                [("supplier_cnt", "nunique", "ps_suppkey")])
    return Sort(g, [("supplier_cnt", False), ("p_brand", True),
                    ("p_type", True), ("p_size", True)])


# ---------------------------------------------------------------------------
# Q17 — small-quantity-order revenue (correlated agg subquery)
# ---------------------------------------------------------------------------

def q17(sf: float) -> PlanNode:
    part = Scan("part", filter=(col("p_brand") == "Brand#23")
                & (col("p_container") == "MED BOX"))
    li = Scan("lineitem")
    li2 = Scan("lineitem", alias="l2")
    avg_q = Project(
        GroupBy(li2, ["l2_l_partkey"], [("avg_qty", "mean", "l2_l_quantity")]),
        {"avg_partkey": col("l2_l_partkey"), "avg_qty": col("avg_qty")})
    sub = SubqueryScan(avg_q, "avgqty")
    j = Join(li, part, ["l_partkey"], ["p_partkey"])
    j = Join(j, sub, ["l_partkey"], ["avg_partkey"],
             extra=col("l_quantity") < lit(0.2) * col("avg_qty"))
    g = GroupBy(j, [], [("total", "sum", "l_extendedprice")])
    return Project(g, {"avg_yearly": col("total") / 7.0})


# ---------------------------------------------------------------------------
# Q18 — large-volume customers (agg subquery joined back to the fact table)
# ---------------------------------------------------------------------------

def q18(sf: float) -> PlanNode:
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
                    "o_totalprice"],
                [("sum_qty", "sum", "l_quantity")])
    return Limit(Sort(g, [("o_totalprice", False), ("o_orderdate", True)]),
                 100)


# ---------------------------------------------------------------------------
# Q19 — discounted revenue (disjunctive join predicate)
# ---------------------------------------------------------------------------

def q19(sf: float) -> PlanNode:
    li = Scan("lineitem", filter=(
        isin(col("l_shipmode"), ["AIR", "REG AIR"])
        & (col("l_shipinstruct") == "DELIVER IN PERSON")
        & (col("l_quantity") >= 1) & (col("l_quantity") <= 30)))
    part = Scan("part", filter=(col("p_size") >= 1) & (col("p_size") <= 15))
    branch1 = ((col("p_brand") == "Brand#12")
               & isin(col("p_container"),
                      ["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
               & between(col("l_quantity"), 1, 11)
               & between(col("p_size"), 1, 5))
    branch2 = ((col("p_brand") == "Brand#23")
               & isin(col("p_container"),
                      ["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
               & between(col("l_quantity"), 10, 20)
               & between(col("p_size"), 1, 10))
    branch3 = ((col("p_brand") == "Brand#34")
               & isin(col("p_container"),
                      ["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
               & between(col("l_quantity"), 20, 30)
               & between(col("p_size"), 1, 15))
    j = Join(li, part, ["l_partkey"], ["p_partkey"],
             extra=branch1 | branch2 | branch3)
    j = Project(j, {"rev": col("l_extendedprice") * (1 - col("l_discount"))})
    return GroupBy(j, [], [("revenue", "sum", "rev")])


# ---------------------------------------------------------------------------
# Q20 — potential part promotion (nested semi-joins)
# ---------------------------------------------------------------------------

def q20(sf: float) -> PlanNode:
    lo, hi = date("1994-01-01"), date("1995-01-01")
    li = Scan("lineitem", alias="lq",
              filter=(col("lq_l_shipdate") >= lo)
              & (col("lq_l_shipdate") < hi))
    halfsum = Project(
        GroupBy(li, ["lq_l_partkey", "lq_l_suppkey"],
                [("qty", "sum", "lq_l_quantity")]),
        {"h_partkey": col("lq_l_partkey"), "h_suppkey": col("lq_l_suppkey"),
         "half_qty": lit(0.5) * col("qty")})
    sub = SubqueryScan(halfsum, "halfqty")
    part = Scan("part", filter=like(col("p_name"), "forest%"))
    ps = Scan("partsupp")
    inner = Join(ps, part, ["ps_partkey"], ["p_partkey"], how="semi")
    inner = Join(inner, sub, ["ps_partkey", "ps_suppkey"],
                 ["h_partkey", "h_suppkey"],
                 extra=col("ps_availqty") > col("half_qty"))
    supp = Scan("supplier")
    nat = Scan("nation", filter=col("n_name") == "CANADA")
    j = Join(supp, inner, ["s_suppkey"], ["ps_suppkey"], how="semi")
    j = Join(j, nat, ["s_nationkey"], ["n_nationkey"])
    j = Project(j, _passthrough("s_name", "s_address"))
    return Sort(j, [("s_name", True)])


# ---------------------------------------------------------------------------
# Q21 — suppliers who kept orders waiting
# ---------------------------------------------------------------------------

def q21(sf: float) -> PlanNode:
    # G2: suppliers per order (exists other supplier <=> nsupp >= 2)
    l2 = Scan("lineitem", alias="l2")
    g2 = Project(
        GroupBy(l2, ["l2_l_orderkey"], [("nsupp", "nunique", "l2_l_suppkey")],
                having=col("nsupp") >= 2),
        {"g2_orderkey": col("l2_l_orderkey")})
    # G3: late suppliers per order (no other late supplier <=> nlate == 1)
    l3 = Scan("lineitem", alias="l3",
              filter=col("l3_l_receiptdate") > col("l3_l_commitdate"))
    g3 = Project(
        GroupBy(l3, ["l3_l_orderkey"], [("nlate", "nunique", "l3_l_suppkey")],
                having=col("nlate") == 1),
        {"g3_orderkey": col("l3_l_orderkey")})
    li = Scan("lineitem",
              filter=col("l_receiptdate") > col("l_commitdate"))
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
    return Limit(Sort(g, [("numwait", False), ("s_name", True)]), 100)


# ---------------------------------------------------------------------------
# Q22 — global sales opportunity (anti join + scalar subquery)
# ---------------------------------------------------------------------------

_CODES = ["13", "31", "23", "29", "30", "18", "17"]


def q22(sf: float) -> PlanNode:
    cust = Scan("customer",
                filter=isin(substring(col("c_phone"), 1, 2), _CODES))
    avg_sub = GroupBy(
        Scan("customer", alias="c2",
             filter=(col("c2_c_acctbal") > 0.0)
             & isin(substring(col("c2_c_phone"), 1, 2), _CODES)),
        [], [("avg_bal", "mean", "c2_c_acctbal")])
    j = Bind(cust, "avg_bal", avg_sub, "avg_bal")
    j = Filter(j, col("c_acctbal") > col("avg_bal"))
    orders = Scan("orders")
    j = Join(j, orders, ["c_custkey"], ["o_custkey"], how="anti")
    j = Project(j, {"cntrycode": substring(col("c_phone"), 1, 2),
                    "c_acctbal": col("c_acctbal")})
    g = GroupBy(j, ["cntrycode"], [("numcust", "count", ""),
                                   ("totacctbal", "sum", "c_acctbal")])
    return Sort(g, [("cntrycode", True)])


# ---------------------------------------------------------------------------

QUERIES = {
    2: q2, 3: q3, 4: q4, 5: q5, 7: q7, 8: q8, 9: q9, 10: q10, 11: q11,
    12: q12, 13: q13, 14: q14, 15: q15, 16: q16, 17: q17, 18: q18,
    19: q19, 20: q20, 21: q21, 22: q22,
}


def build_query(n: int, sf: float = 0.01, **kw) -> PlanNode:
    return QUERIES[n](sf, **kw)
