"""SSB Q3.3 (O'Neil, O'Neil, Chen, Revilak, TPCTC 2009, section 3.1;
the specification's fixed constants). Flight 3: two cities on both sides."""
from perfbench import reflib

ORDER_BY = [("d_year", True), ("revenue", False)]
CITIES = ["UNITED KI1", "UNITED KI5"]


def plan(sf):
    """The program's plan: lineorder probes customer, supplier and date."""
    from repro_torch.relational.expr import between, col, isin
    from repro_torch.relational.plan import GroupBy, Join, Scan, Sort
    lo = Scan("lineorder")
    c = Scan("customer", filter=isin(col("c_city"), CITIES))
    s = Scan("supplier", filter=isin(col("s_city"), CITIES))
    d = Scan("date", filter=between(col("d_year"), 1992, 1997))
    j = Join(lo, c, ["lo_custkey"], ["c_custkey"])
    j = Join(j, s, ["lo_suppkey"], ["s_suppkey"])
    j = Join(j, d, ["lo_orderdate"], ["d_datekey"])
    g = GroupBy(j, ["c_city", "s_city", "d_year"],
                [("revenue", "sum", "lo_revenue")])
    return Sort(g, ORDER_BY)


def reference(db, acc):
    lo, c, s, d = db["lineorder"], db["customer"], db["supplier"], db["date"]
    ci = reflib.lookup(c["c_custkey"], lo["lo_custkey"])
    si = reflib.lookup(s["s_suppkey"], lo["lo_suppkey"])
    di = reflib.lookup(d["d_datekey"], lo["lo_orderdate"])
    keep = (reflib.isin(c["c_city"], CITIES))[ci] \
        & (reflib.isin(s["s_city"], CITIES))[si] \
        & ((d["d_year"] >= 1992) & (d["d_year"] <= 1997))[di]
    gid, (cc, sc, year) = reflib.group_by([
        c["c_city"].codes[ci[keep]], s["s_city"].codes[si[keep]],
        d["d_year"][di[keep]]])
    rev = reflib.measure(lo["lo_revenue"][keep], acc)
    return reflib.order_by(reflib.answer({
        "c_city": c["c_city"].vocab[cc], "s_city": s["s_city"].vocab[sc],
        "d_year": year,
        "revenue": reflib.group_sum(gid, len(year), rev, acc)}), ORDER_BY)
