"""SSB Q2.1 (O'Neil, O'Neil, Chen, Revilak, TPCTC 2009, section 3.1;
the specification's fixed constants). Flight 2: a part category and a
supplier region."""
from perfbench import reflib

ORDER_BY = [("d_year", True), ("p_brand1", True)]


def plan(sf):
    """The program's plan: lineorder probes part, supplier and date."""
    from repro_torch.relational.expr import col
    from repro_torch.relational.plan import GroupBy, Join, Scan, Sort
    lo = Scan("lineorder")
    p = Scan("part", filter=col("p_category") == "MFGR#12")
    s = Scan("supplier", filter=col("s_region") == "AMERICA")
    d = Scan("date")
    j = Join(lo, p, ["lo_partkey"], ["p_partkey"])
    j = Join(j, s, ["lo_suppkey"], ["s_suppkey"])
    j = Join(j, d, ["lo_orderdate"], ["d_datekey"])
    g = GroupBy(j, ["d_year", "p_brand1"], [("revenue", "sum", "lo_revenue")])
    return Sort(g, ORDER_BY)


def reference(db, acc):
    lo, p, s, d = db["lineorder"], db["part"], db["supplier"], db["date"]
    pi = reflib.lookup(p["p_partkey"], lo["lo_partkey"])
    si = reflib.lookup(s["s_suppkey"], lo["lo_suppkey"])
    keep = (reflib.eq(p["p_category"], "MFGR#12"))[pi] \
        & reflib.eq(s["s_region"], "AMERICA")[si]
    di = reflib.lookup(d["d_datekey"], lo["lo_orderdate"][keep])
    gid, (year, brand) = reflib.group_by([d["d_year"][di],
                                          p["p_brand1"].codes[pi[keep]]])
    rev = reflib.measure(lo["lo_revenue"][keep], acc)
    return reflib.order_by(reflib.answer({
        "d_year": year, "p_brand1": p["p_brand1"].vocab[brand],
        "revenue": reflib.group_sum(gid, len(year), rev, acc)}), ORDER_BY)
