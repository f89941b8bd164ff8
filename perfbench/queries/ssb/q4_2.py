"""SSB Q4.2 (O'Neil, O'Neil, Chen, Revilak, TPCTC 2009, section 3.1;
the specification's fixed constants). Flight 4: two years, by supplier
nation and part category."""
import numpy as np

from perfbench import reflib

KEYS = ["d_year", "s_nation", "p_category"]
ORDER_BY = [(k, True) for k in KEYS]


def plan(sf):
    """The program's plan: lineorder probes all four dimensions."""
    from repro_torch.relational.expr import col, isin
    from repro_torch.relational.plan import GroupBy, Join, Project, Scan, Sort
    lo = Scan("lineorder")
    c = Scan("customer", filter=col("c_region") == "AMERICA")
    s = Scan("supplier", filter=col("s_region") == "AMERICA")
    p = Scan("part", filter=isin(col("p_mfgr"), ["MFGR#1", "MFGR#2"]))
    d = Scan("date", filter=isin(col("d_year"), [1997, 1998]))
    j = Join(lo, c, ["lo_custkey"], ["c_custkey"])
    j = Join(j, s, ["lo_suppkey"], ["s_suppkey"])
    j = Join(j, p, ["lo_partkey"], ["p_partkey"])
    j = Join(j, d, ["lo_orderdate"], ["d_datekey"])
    j = Project(j, {**{k: col(k) for k in KEYS},
                    "gain": col("lo_revenue") - col("lo_supplycost")})
    g = GroupBy(j, KEYS, [("profit", "sum", "gain")])
    return Sort(g, ORDER_BY)


def reference(db, acc):
    lo, c, s, p, d = (db["lineorder"], db["customer"], db["supplier"],
                      db["part"], db["date"])
    ci = reflib.lookup(c["c_custkey"], lo["lo_custkey"])
    si = reflib.lookup(s["s_suppkey"], lo["lo_suppkey"])
    pi = reflib.lookup(p["p_partkey"], lo["lo_partkey"])
    di = reflib.lookup(d["d_datekey"], lo["lo_orderdate"])
    keep = reflib.eq(c["c_region"], "AMERICA")[ci] \
        & reflib.eq(s["s_region"], "AMERICA")[si] \
        & reflib.isin(p["p_mfgr"], ["MFGR#1", "MFGR#2"])[pi] \
        & np.isin(d["d_year"], [1997, 1998])[di]
    gid, (year, nation, category) = reflib.group_by([
        d["d_year"][di[keep]], s["s_nation"].codes[si[keep]],
        p["p_category"].codes[pi[keep]]])
    gain = (reflib.measure(lo["lo_revenue"][keep], acc)
            - reflib.measure(lo["lo_supplycost"][keep], acc))
    return reflib.order_by(reflib.answer({
        "d_year": year, "s_nation": s["s_nation"].vocab[nation],
        "p_category": p["p_category"].vocab[category],
        "profit": reflib.group_sum(gid, len(year), gain, acc)}), ORDER_BY)
