"""Star Schema Benchmark data at a scale factor, as plain arrays, from a
seed.

Written from the SSB paper: P. O'Neil, E. O'Neil, X. Chen, S. Revilak,
"The Star Schema Benchmark and Augmented Fact Table Indexing", TPCTC
2009, and the SSB specification (revision 3) it summarises. Schema and
cardinalities:

- lineorder: 1,500,000 x SF orders of 1-7 lines each (about 6,000,000 x
  SF rows); lo_orderdate and lo_commitdate reference d_datekey;
  lo_custkey, lo_partkey and lo_suppkey are uniform over their tables.
- customer: 30,000 x SF; c_city is the first 9 characters of the nation
  name, padded with blanks, and a digit 0-9 (250 cities); c_nation one of
  TPC-H's 25 nations, c_region its region; c_mktsegment one of 5.
- supplier: 2,000 x SF, with s_city, s_nation and s_region as customer's.
- part: 200,000 x floor(1 + log2 SF); p_mfgr 'MFGR#1'-'MFGR#5',
  p_category p_mfgr and 1-5 (25 values), p_brand1 p_category and 1-40
  (1,000 values), p_color one of 92, p_type one of TPC-H's 150, p_size
  1-50, p_container one of TPC-H's 40.
- date: 7 years of days from 1992-01-01, 2,556 rows; d_datekey is
  yyyymmdd, d_yearmonth 'Dec1997', d_weeknuminyear the day of the year's
  week counted from 1 on 1 January.

Measures follow the paper's derivation from TPC-H, in cents:
lo_extendedprice = lo_quantity (1-50) x the part's TPC-H retail price;
lo_discount 0-10 (percent); lo_tax 0-8; lo_revenue = lo_extendedprice x
(100 - lo_discount) / 100 (integer division); lo_supplycost uniform on
TPC-H's ps_supplycost range, 100-100,000; lo_ordtotalprice the order's
sum of extendedprice x (100 + tax) x (100 - discount) / 10,000. The
orderdate is uniform over the days that leave 151 days before the end
(TPC-H's rule); the commitdate 30-90 days after it.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from perfbench.data.tpch import (COLORS, CONT_S1, CONT_S2, NATIONS,
                                 PRIORITIES, REGIONS, SEGMENTS, SHIPMODES,
                                 TYPE_S1, TYPE_S2, TYPE_S3)
from perfbench.reflib import categorical, strings

DAYS = 2556
MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]
WEEKDAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
            "Saturday", "Sunday"]
SEASONS = ["Winter", "Spring", "Summer", "Fall", "Christmas"]


def _cities(nation: np.ndarray, rng) -> np.ndarray:
    """City codes: nation * 10 + a digit 0-9."""
    return nation * 10 + rng.integers(0, 10, len(nation))


def _city_vocab() -> list:
    return [f"{name[:9]:<9}{d}" for name, _ in NATIONS for d in range(10)]


def _geo(rng, n: int) -> Dict[str, object]:
    """city, nation and region of n rows (one draw of the nation)."""
    nation = rng.integers(0, 25, n)
    city = _cities(nation, rng)
    region = np.array([r for _, r in NATIONS])[nation]
    return {"city": categorical(city, _city_vocab()),
            "nation": categorical(nation, [n for n, _ in NATIONS]),
            "region": categorical(region, REGIONS),
            "nation_codes": nation}


def _phones(rng, nation: np.ndarray):
    suffix = rng.integers(0, 40, len(nation))
    cc = (10 + nation).astype("U2")
    return strings(np.char.add(np.char.add(cc, "-555-000-"),
                               (1000 + suffix).astype("U4")))


def _dates() -> Dict[str, object]:
    day = np.datetime64("1992-01-01") + np.arange(DAYS)
    y = day.astype("datetime64[Y]").astype(np.int64) + 1970
    m = day.astype("datetime64[M]").astype(np.int64) % 12 + 1
    d = (day - day.astype("datetime64[M]")).astype(np.int64) + 1
    doy = (day - day.astype("datetime64[Y]")).astype(np.int64) + 1
    dow = (day.astype(np.int64) + 3) % 7          # 1970-01-01: Thursday
    last_of_month = (day + 1).astype("datetime64[M]") != \
        day.astype("datetime64[M]")
    season = np.select([m == 12, m <= 2, m <= 5, m <= 8],
                       [4, 0, 1, 2], 3)
    month_abbr = np.array([s[:3] for s in MONTHS])
    text = [f"{MONTHS[mi - 1]} {di}, {yi}" for yi, mi, di in zip(y, m, d)]
    holiday = ((m == 1) & (d == 1)) | ((m == 7) & (d == 4)) | \
        ((m == 12) & (d == 25))
    return {
        "d_datekey": y * 10000 + m * 100 + d,
        "d_date": strings(np.array(text)),
        "d_dayofweek": categorical(dow, WEEKDAYS),
        "d_month": categorical(m - 1, MONTHS),
        "d_year": y,
        "d_yearmonthnum": y * 100 + m,
        "d_yearmonth": strings(np.char.add(month_abbr[m - 1],
                                           y.astype("U4"))),
        "d_daynuminweek": dow + 1,
        "d_daynuminmonth": d,
        "d_daynuminyear": doy,
        "d_monthnuminyear": m,
        "d_weeknuminyear": (doy - 1) // 7 + 1,
        "d_sellingseason": categorical(season, SEASONS),
        "d_lastdayinweekfl": (dow == 6).astype(np.int64),
        "d_lastdayinmonthfl": last_of_month.astype(np.int64),
        "d_holidayfl": holiday.astype(np.int64),
        "d_weekdayfl": (dow < 5).astype(np.int64)}


def generate(scale: float, seed: int) -> Dict[str, Dict[str, object]]:
    """Every table at scale factor `scale`: name -> column -> array."""
    rng = np.random.default_rng(seed)
    sf = scale
    n_cust = max(30, int(30_000 * sf))
    n_supp = max(10, int(2_000 * sf))
    # 200,000 x floor(1 + log2 SF) from SF 1; in proportion below it
    n_part = max(40, int(200_000 * (math.floor(1 + math.log2(sf))
                                    if sf >= 1 else sf)))
    n_ord = max(100, int(1_500_000 * sf))
    db: Dict[str, Dict[str, object]] = {}

    db["date"] = _dates()

    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    g = _geo(rng, n_cust)
    db["customer"] = {
        "c_custkey": ck,
        "c_name": strings(np.char.add("Customer#", ck.astype("U9"))),
        "c_address": strings(np.char.add("addrC", (ck % 997).astype("U4"))),
        "c_city": g["city"], "c_nation": g["nation"], "c_region": g["region"],
        "c_phone": _phones(rng, g["nation_codes"]),
        "c_mktsegment": categorical(rng.integers(0, 5, n_cust), SEGMENTS)}

    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    g = _geo(rng, n_supp)
    db["supplier"] = {
        "s_suppkey": sk,
        "s_name": strings(np.char.add("Supplier#", sk.astype("U9"))),
        "s_address": strings(np.char.add("addrS", (sk % 997).astype("U4"))),
        "s_city": g["city"], "s_nation": g["nation"], "s_region": g["region"],
        "s_phone": _phones(rng, g["nation_codes"])}

    pk = np.arange(1, n_part + 1, dtype=np.int64)
    mfgr = rng.integers(1, 6, n_part)
    cat = rng.integers(1, 6, n_part)
    brand = rng.integers(1, 41, n_part)
    c1, c2 = rng.choice(len(COLORS), size=(2, n_part))
    types = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
             for c in TYPE_S3]
    containers = [f"{a} {b}" for a in CONT_S1 for b in CONT_S2]
    color_names = np.array(COLORS)
    db["part"] = {
        "p_partkey": pk,
        "p_name": strings(np.char.add(np.char.add(color_names[c1], " "),
                                      color_names[c2])),
        "p_mfgr": categorical(mfgr - 1, [f"MFGR#{i}" for i in range(1, 6)]),
        "p_category": categorical((mfgr - 1) * 5 + cat - 1,
                                  [f"MFGR#{i}{j}" for i in range(1, 6)
                                   for j in range(1, 6)]),
        "p_brand1": categorical(((mfgr - 1) * 5 + cat - 1) * 40 + brand - 1,
                                [f"MFGR#{i}{j}{b}" for i in range(1, 6)
                                 for j in range(1, 6) for b in range(1, 41)]),
        "p_color": categorical(rng.integers(0, len(COLORS), n_part), COLORS),
        "p_type": categorical(rng.integers(0, len(types), n_part), types),
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_container": categorical(rng.integers(0, len(containers), n_part),
                                   containers)}
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)   # cents

    per_order = rng.integers(1, 8, n_ord)
    n_lo = int(per_order.sum())
    starts = np.cumsum(per_order) - per_order
    ok = np.arange(1, n_ord + 1, dtype=np.int64)
    o_day = rng.integers(0, DAYS - 151, n_ord)
    o_cust = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
    o_prio = rng.integers(0, 5, n_ord)
    lo_day = np.repeat(o_day, per_order)
    part = rng.integers(1, n_part + 1, n_lo).astype(np.int64)
    qty = rng.integers(1, 51, n_lo).astype(np.int64)
    disc = rng.integers(0, 11, n_lo).astype(np.int64)
    tax = rng.integers(0, 9, n_lo).astype(np.int64)
    price = qty * retail[part - 1]
    datekey = db["date"]["d_datekey"]
    line_total = price * (100 + tax) * (100 - disc) // 10000
    db["lineorder"] = {
        "lo_orderkey": np.repeat(ok, per_order),
        "lo_linenumber": np.arange(n_lo, dtype=np.int64)
        - np.repeat(starts, per_order) + 1,
        "lo_custkey": np.repeat(o_cust, per_order),
        "lo_partkey": part,
        "lo_suppkey": rng.integers(1, n_supp + 1, n_lo).astype(np.int64),
        "lo_orderdate": datekey[lo_day],
        "lo_orderpriority": categorical(np.repeat(o_prio, per_order),
                                        PRIORITIES),
        "lo_shippriority": np.zeros(n_lo, np.int64),
        "lo_quantity": qty,
        "lo_extendedprice": price,
        "lo_ordtotalprice": np.repeat(np.add.reduceat(line_total, starts),
                                      per_order),
        "lo_discount": disc,
        "lo_revenue": price * (100 - disc) // 100,
        "lo_supplycost": rng.integers(100, 100_001, n_lo).astype(np.int64),
        "lo_tax": tax,
        "lo_commitdate": datekey[lo_day + rng.integers(30, 91, n_lo)],
        "lo_shipmode": categorical(rng.integers(0, 7, n_lo), SHIPMODES)}
    return db
