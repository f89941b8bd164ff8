"""SSB Q1.2 (O'Neil, O'Neil, Chen, Revilak, TPCTC 2009, section 3.1;
the specification's fixed constants). Flight 1: one month."""
from perfbench import reflib

ORDER_BY = []


def plan(sf):
    """The program's plan: lineorder probes the date dimension."""
    from repro_torch.relational.expr import between, col
    from repro_torch.relational.plan import GroupBy, Join, Project, Scan
    lo = Scan("lineorder", filter=(between(col("lo_discount"), 4, 6)
                                   & between(col("lo_quantity"), 26, 35)))
    d = Scan("date", filter=col("d_yearmonthnum") == 199401)
    j = Join(lo, d, ["lo_orderdate"], ["d_datekey"])
    j = Project(j, {"r": col("lo_extendedprice") * col("lo_discount")})
    return GroupBy(j, [], [("revenue", "sum", "r")])


def reference(db, acc):
    lo, d = db["lineorder"], db["date"]
    di = reflib.lookup(d["d_datekey"], lo["lo_orderdate"])
    disc, qty = lo["lo_discount"], lo["lo_quantity"]
    keep = (d["d_yearmonthnum"] == 199401)[di] & (disc >= 4) & (disc <= 6) \
        & (qty >= 26) & (qty <= 35)
    r = (reflib.measure(lo["lo_extendedprice"][keep], acc)
         * reflib.measure(disc[keep], acc))
    return reflib.answer({"revenue": reflib.total(r, acc)})
