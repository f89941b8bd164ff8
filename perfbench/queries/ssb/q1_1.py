"""SSB Q1.1 (O'Neil, O'Neil, Chen, Revilak, TPCTC 2009, section 3.1;
the specification's fixed constants). Flight 1: one year,
a discount and a quantity band; the date dimension alone."""
from perfbench import reflib

ORDER_BY = []


def plan(sf):
    """The program's plan: lineorder probes the date dimension."""
    from repro_torch.relational.expr import between, col
    from repro_torch.relational.plan import GroupBy, Join, Project, Scan
    lo = Scan("lineorder", filter=(between(col("lo_discount"), 1, 3)
                                   & (col("lo_quantity") < 25)))
    d = Scan("date", filter=col("d_year") == 1993)
    j = Join(lo, d, ["lo_orderdate"], ["d_datekey"])
    j = Project(j, {"r": col("lo_extendedprice") * col("lo_discount")})
    return GroupBy(j, [], [("revenue", "sum", "r")])


def reference(db, acc):
    lo, d = db["lineorder"], db["date"]
    di = reflib.lookup(d["d_datekey"], lo["lo_orderdate"])
    disc, qty = lo["lo_discount"], lo["lo_quantity"]
    keep = (d["d_year"] == 1993)[di] & (disc >= 1) & (disc <= 3) & (qty < 25)
    r = (reflib.measure(lo["lo_extendedprice"][keep], acc)
         * reflib.measure(disc[keep], acc))
    return reflib.answer({"revenue": reflib.total(r, acc)})
