"""SSB Q1.3 (O'Neil, O'Neil, Chen, Revilak, TPCTC 2009, section 3.1;
the specification's fixed constants). Flight 1: one week."""
from perfbench import reflib

ORDER_BY = []


def plan(sf):
    """The program's plan: lineorder probes the date dimension."""
    from repro_torch.relational.expr import between, col
    from repro_torch.relational.plan import GroupBy, Join, Project, Scan
    lo = Scan("lineorder", filter=(between(col("lo_discount"), 5, 7)
                                   & between(col("lo_quantity"), 26, 35)))
    d = Scan("date", filter=((col("d_weeknuminyear") == 6)
                            & (col("d_year") == 1994)))
    j = Join(lo, d, ["lo_orderdate"], ["d_datekey"])
    j = Project(j, {"r": col("lo_extendedprice") * col("lo_discount")})
    return GroupBy(j, [], [("revenue", "sum", "r")])


def reference(db, acc):
    lo, d = db["lineorder"], db["date"]
    di = reflib.lookup(d["d_datekey"], lo["lo_orderdate"])
    disc, qty = lo["lo_discount"], lo["lo_quantity"]
    week = (d["d_weeknuminyear"] == 6) & (d["d_year"] == 1994)
    keep = week[di] & (disc >= 5) & (disc <= 7) & (qty >= 26) & (qty <= 35)
    r = (reflib.measure(lo["lo_extendedprice"][keep], acc)
         * reflib.measure(disc[keep], acc))
    return reflib.answer({"revenue": reflib.total(r, acc)})
