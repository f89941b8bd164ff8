"""numpy dbgen: TPC-H tables at an arbitrary scale factor.

Faithful to the TPC-H v3 specification in everything the 20 join queries
observe: cardinalities and key ranges, FK relationships (including
l_(partkey,suppkey) ⊆ partsupp — Q9's cyclic join graph depends on it),
value distributions and the derived-date rules, and the categorical
domains every predicate touches (brands, types, containers, segments,
priorities, ship modes/instructs, nation/region names, phone country
codes, comment phrases for Q13/Q16).

Free-text columns are drawn from bounded pre-sampled vocabularies with the
spec's phrase frequencies, so dictionary encoding stays compact while LIKE
selectivities match (DESIGN.md §7).
"""
from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

from repro_torch.relational.table import Table

TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")

_EPOCH = datetime.date(1970, 1, 1).toordinal()


def date(s: str) -> int:
    """'YYYY-MM-DD' -> int32 days since epoch (engine date literal)."""
    y, m, d = map(int, s.split("-"))
    return datetime.date(y, m, d).toordinal() - _EPOCH


DATE_MIN = date("1992-01-01")
DATE_MAX = date("1998-08-02")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# spec nation -> region mapping
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCTS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
    "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
    "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
    "goldenrod", "green", "grey", "honeydew", "hot", "hotpink", "indian",
    "ivory", "khaki", "lace", "lavender", "lawn", "lemon", "light",
    "lime", "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow",
    "spring", "steel", "tan", "thistle", "tomato", "turquoise", "violet",
    "wheat", "white", "yellow",
]
# Q13-relevant order-comment phrases and Q16 supplier complaints
_O_PHRASE = "special requests"
_S_PHRASE = "Customer Complaints"


def _comment_vocab(rng, n: int, phrase: str, frac: float) -> np.ndarray:
    """n distinct comments, ~frac of them containing phrase."""
    words = np.array(COLORS)
    base = [" ".join(rng.choice(words, size=4)) + f" #{i}" for i in range(n)]
    k = int(n * frac)
    for i in rng.choice(n, size=k, replace=False):
        parts = base[i].split(" ")
        base[i] = parts[0] + " " + phrase.split(" ")[0] + " xx " + \
            phrase.split(" ")[1] + " " + " ".join(parts[1:])
    return np.array(base)


def generate(sf: float = 0.01, seed: int = 0) -> Dict[str, Table]:
    """Generate all eight tables at scale factor `sf`."""
    rng = np.random.default_rng(seed)
    n_supp = max(10, int(10_000 * sf))
    n_part = max(40, int(200_000 * sf))
    n_cust = max(30, int(150_000 * sf))
    n_ord = max(100, int(1_500_000 * sf))

    out: Dict[str, Table] = {}

    # -- region / nation ----------------------------------------------------
    out["region"] = Table.from_arrays({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(REGIONS),
    }, "region")
    out["nation"] = Table.from_arrays({
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.array([n for n, _ in NATIONS]),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
    }, "nation")

    # -- supplier ------------------------------------------------------------
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    s_nation = rng.integers(0, 25, n_supp).astype(np.int64)
    s_comments = _comment_vocab(rng, 500, _S_PHRASE, 0.01)  # spec: 5/10000
    out["supplier"] = Table.from_arrays({
        "s_suppkey": sk,
        "s_name": np.char.add("Supplier#", sk.astype("U9")),
        "s_address": np.char.add("addrS", (sk % 997).astype("U4")),
        "s_nationkey": s_nation,
        "s_phone": _phones(rng, s_nation),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": s_comments[rng.integers(0, len(s_comments), n_supp)],
    }, "supplier")

    # -- part ------------------------------------------------------------
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    # bounded vocab of 5-color names; P(name contains a given color) ~ 5/92
    name_vocab = np.array([
        " ".join(rng.choice(COLORS, size=5, replace=False))
        for _ in range(min(4000, max(200, n_part // 10)))])
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    out["part"] = Table.from_arrays({
        "p_partkey": pk,
        "p_name": name_vocab[rng.integers(0, len(name_vocab), n_part)],
        "p_mfgr": np.char.add("Manufacturer#",
                              brand_m.astype("U1")),
        "p_brand": np.char.add(np.char.add("Brand#", brand_m.astype("U1")),
                               brand_n.astype("U1")),
        "p_type": (np.array(TYPE_S1)[rng.integers(0, 6, n_part)]
                   .astype("U32")
                   + " " + np.array(TYPE_S2)[rng.integers(0, 5, n_part)]
                   + " " + np.array(TYPE_S3)[rng.integers(0, 5, n_part)]),
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_container": (np.array(CONT_S1)[rng.integers(0, 5, n_part)]
                        .astype("U16") + " "
                        + np.array(CONT_S2)[rng.integers(0, 8, n_part)]),
        "p_retailprice": np.round(
            (90000 + pk % 20001 + 100 * (pk % 1000)) / 100.0, 2),
    }, "part")

    # -- partsupp (4 suppliers per part, spec formula) -----------------------
    i = np.repeat(np.arange(4), n_part)
    psp = np.tile(pk, 4)
    s = np.int64(n_supp)
    ps_supp = ((psp + i * (s // 4 + (psp - 1) // s)) % s + 1).astype(np.int64)
    out["partsupp"] = Table.from_arrays({
        "ps_partkey": psp,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10000, 4 * n_part).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, 4 * n_part), 2),
    }, "partsupp")

    # -- customer ------------------------------------------------------------
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nation = rng.integers(0, 25, n_cust).astype(np.int64)
    out["customer"] = Table.from_arrays({
        "c_custkey": ck,
        "c_name": np.char.add("Customer#", ck.astype("U9")),
        "c_address": np.char.add("addrC", (ck % 997).astype("U4")),
        "c_nationkey": c_nation,
        "c_phone": _phones(rng, c_nation),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": np.array(SEGMENTS)[rng.integers(0, 5, n_cust)],
    }, "customer")

    # -- orders (custkey % 3 != 0 have orders, per spec) ----------------------
    ok = np.arange(1, n_ord + 1, dtype=np.int64)
    eligible = ck[ck % 3 != 0]
    o_cust = eligible[rng.integers(0, len(eligible), n_ord)]
    o_date = rng.integers(DATE_MIN, DATE_MAX - 151, n_ord).astype(np.int32)
    o_comments = _comment_vocab(rng, 1000, _O_PHRASE, 0.05)
    out["orders"] = Table.from_arrays({
        "o_orderkey": ok,
        "o_custkey": o_cust,
        "o_orderdate": o_date.astype(np.int64),
        "o_orderpriority": np.array(PRIORITIES)[rng.integers(0, 5, n_ord)],
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": o_comments[rng.integers(0, len(o_comments), n_ord)],
    }, "orders")

    # -- lineitem -------------------------------------------------------------
    per_order = rng.integers(1, 8, n_ord)
    n_li = int(per_order.sum())
    l_order = np.repeat(ok, per_order)
    l_odate = np.repeat(o_date, per_order).astype(np.int64)
    # pick a partsupp row so (partkey, suppkey) is a valid FK (Q9 cycle)
    ps_row = rng.integers(0, 4 * n_part, n_li)
    l_part = psp[ps_row]
    l_supp = ps_supp[ps_row]
    l_qty = rng.integers(1, 51, n_li).astype(np.int64)
    retail = (90000 + l_part % 20001 + 100 * (l_part % 1000)) / 100.0
    l_ship = l_odate + rng.integers(1, 122, n_li)
    l_commit = l_odate + rng.integers(30, 91, n_li)
    l_receipt = l_ship + rng.integers(1, 31, n_li)
    cutoff = date("1995-06-17")
    l_returnflag = np.where(
        l_receipt <= cutoff,
        np.where(rng.random(n_li) < 0.5, "R", "A"), "N")
    out["lineitem"] = Table.from_arrays({
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_linenumber": _linenumbers(per_order),
        "l_quantity": l_qty,
        "l_extendedprice": np.round(l_qty * retail, 2),
        "l_discount": np.round(rng.integers(0, 11, n_li) / 100.0, 2),
        "l_tax": np.round(rng.integers(0, 9, n_li) / 100.0, 2),
        "l_returnflag": l_returnflag,
        "l_linestatus": np.where(l_ship <= cutoff, "F", "O"),
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_shipinstruct": np.array(INSTRUCTS)[rng.integers(0, 4, n_li)],
        "l_shipmode": np.array(SHIPMODES)[rng.integers(0, 7, n_li)],
    }, "lineitem")

    # orders.o_orderstatus: F if all its lineitems F, O if all O, else P
    stat = out["lineitem"]["l_linestatus"]
    is_f = (stat.dictionary[stat.data] == "F")
    ends = np.cumsum(per_order)
    starts = ends - per_order
    sums = np.add.reduceat(is_f.astype(np.int64), starts)
    sums[per_order == 0] = 0
    status = np.where(sums == per_order, "F",
                      np.where(sums == 0, "O", "P"))
    out["orders"] = out["orders"].with_column(
        "o_orderstatus",
        Table.from_arrays({"x": status}, "t")["x"])

    # o_totalprice = sum of line extendedprice*(1+tax)*(1-discount)
    li = out["lineitem"]
    val = (li.array("l_extendedprice") * (1 + li.array("l_tax"))
           * (1 - li.array("l_discount")))
    tp = np.add.reduceat(val, starts)
    tp[per_order == 0] = 0.0
    out["orders"] = out["orders"].with_column(
        "o_totalprice", Table.from_arrays({"x": np.round(tp, 2)}, "t")["x"])

    return out


def _phones(rng, nationkey: np.ndarray) -> np.ndarray:
    """'CC-xxx-xxx-xxxx' with CC = 10 + nationkey; bounded suffix vocab."""
    suffix = rng.integers(0, 40, len(nationkey))
    cc = (10 + nationkey).astype("U2")
    return np.char.add(np.char.add(cc, "-555-000-"),
                       (1000 + suffix).astype("U4"))


def _linenumbers(per_order: np.ndarray) -> np.ndarray:
    total = int(per_order.sum())
    ends = np.cumsum(per_order)
    starts = ends - per_order
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(starts, per_order)
    return out + 1
