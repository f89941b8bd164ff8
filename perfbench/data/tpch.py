"""TPC-H data at a scale factor, as plain arrays, from a seed.

A frozen copy of the program's own generator (`repro_torch/tpch/gen.py`
as of this benchmark's first version), so that later changes there do
not move the yardstick. It draws the same values in the same order;
what differs is the output: plain NumPy arrays, with each string column
a `reflib.Strings` (codes into a sorted vocabulary) instead of the
program's `Table`s. A string column is spelled once a distinct value,
not once a row, and never sorted as strings: the same `Strings` as
`reflib.strings` over the rows' values would give, in a third of the
time at SF 10 (`_numbered`, `_modulo`, `_phones`, `categorical`).

Follows the TPC-H specification v3 (clause 4.2) in what the join
queries observe: cardinalities (supplier 10,000 x SF, part 200,000 x SF,
partsupp 4 per part, customer 150,000 x SF, orders 1,500,000 x SF,
lineitem 1-7 per order), key ranges, the foreign keys (a lineitem's
(partkey, suppkey) is a partsupp row, which Q9's cycle needs), value
distributions, the derived dates and statuses, and the categorical
domains every predicate touches. Free text comes from bounded
vocabularies with the spec's phrase frequencies.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from perfbench.reflib import Strings, date, strings

DATE_MIN = date("1992-01-01")
DATE_MAX = date("1998-08-02")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
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
_O_PHRASE = "special requests"       # Q13's order comments
_S_PHRASE = "Customer Complaints"    # Q16's supplier comments


def _comment_vocab(rng, n: int, phrase: str, frac: float) -> np.ndarray:
    """n distinct comments, about `frac` of them holding `phrase`."""
    words = np.array(COLORS)
    base = [" ".join(rng.choice(words, size=4)) + f" #{i}" for i in range(n)]
    k = int(n * frac)
    for i in rng.choice(n, size=k, replace=False):
        parts = base[i].split(" ")
        base[i] = parts[0] + " " + phrase.split(" ")[0] + " xx " + \
            phrase.split(" ")[1] + " " + " ".join(parts[1:])
    return np.array(base)


def _phones(rng, nationkey: np.ndarray) -> Strings:
    """'CC-555-000-xxxx' with CC = 10 + nationkey; bounded suffixes.
    Spelled out once for each of the 25 x 40 values, not once a row."""
    suffix = rng.integers(0, 40, len(nationkey))
    cc = np.repeat(np.arange(10, 35), 40).astype("U2")
    tail = (1000 + np.tile(np.arange(40), 25)).astype("U4")
    vocab = np.char.add(np.char.add(cc, "-555-000-"), tail)
    return categorical(nationkey * 40 + suffix, vocab)


def _numbered(prefix: str, keys: np.ndarray) -> Strings:
    """`prefix` followed by each key in decimal (keys 1..n, distinct),
    as `strings` would give it, without sorting strings: decimal strings
    sort as their digits padded on the right, a prefix first."""
    digits = np.searchsorted(10 ** np.arange(1, 19), keys, side="right") + 1
    width = int(digits.max())
    order = np.lexsort((digits, keys * 10 ** (width - digits)))
    codes = np.empty(len(keys), np.int32)
    codes[order] = np.arange(len(keys), dtype=np.int32)
    return Strings(codes, np.char.add(prefix, keys[order].astype("U9")))


def _modulo(prefix: str, keys: np.ndarray, m: int) -> Strings:
    """`prefix` followed by each key mod `m`, spelled once a value."""
    return categorical(keys % m, np.char.add(prefix,
                                             np.arange(m).astype("U4")))


def categorical(codes: np.ndarray, vocab) -> Strings:
    """`reflib.categorical`, with one gather over the rows instead of
    two: the codes' sorted ranks and their renumbering as one table."""
    vocab = np.asarray(vocab)
    order = np.argsort(vocab, kind="stable")
    rank = np.empty(len(vocab), np.int64)
    rank[order] = np.arange(len(vocab))
    present = np.zeros(len(vocab), bool)
    present[rank] = np.bincount(codes, minlength=len(vocab)) > 0
    table = (np.cumsum(present) - 1)[rank].astype(np.int32)
    return Strings(table[codes], vocab[order][present])


def _linenumbers(per_order: np.ndarray) -> np.ndarray:
    total = int(per_order.sum())
    starts = np.cumsum(per_order) - per_order
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(starts, per_order)
    return out + 1


def generate(scale: float, seed: int) -> Dict[str, Dict[str, object]]:
    """Every table at scale factor `scale`: name -> column -> array."""
    rng = np.random.default_rng(seed)
    sf = scale
    n_supp = max(10, int(10_000 * sf))
    n_part = max(40, int(200_000 * sf))
    n_cust = max(30, int(150_000 * sf))
    n_ord = max(100, int(1_500_000 * sf))
    db: Dict[str, Dict[str, object]] = {}

    db["region"] = {"r_regionkey": np.arange(5, dtype=np.int64),
                    "r_name": strings(np.array(REGIONS))}
    db["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": strings(np.array([n for n, _ in NATIONS])),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64)}

    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    s_nation = rng.integers(0, 25, n_supp).astype(np.int64)
    s_comments = _comment_vocab(rng, 500, _S_PHRASE, 0.01)
    db["supplier"] = {
        "s_suppkey": sk,
        "s_name": _numbered("Supplier#", sk),
        "s_address": _modulo("addrS", sk, 997),
        "s_nationkey": s_nation,
        "s_phone": _phones(rng, s_nation),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": categorical(rng.integers(0, len(s_comments), n_supp),
                                 s_comments)}

    pk = np.arange(1, n_part + 1, dtype=np.int64)
    name_vocab = np.array([
        " ".join(rng.choice(COLORS, size=5, replace=False))
        for _ in range(min(4000, max(200, n_part // 10)))])
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    name_codes = rng.integers(0, len(name_vocab), n_part)
    t1 = rng.integers(0, 6, n_part)
    t2 = rng.integers(0, 5, n_part)
    t3 = rng.integers(0, 5, n_part)
    types = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
             for c in TYPE_S3]
    p_size = rng.integers(1, 51, n_part).astype(np.int64)
    c1 = rng.integers(0, 5, n_part)
    c2 = rng.integers(0, 8, n_part)
    containers = [f"{a} {b}" for a in CONT_S1 for b in CONT_S2]
    db["part"] = {
        "p_partkey": pk,
        "p_name": categorical(name_codes, name_vocab),
        "p_mfgr": categorical(brand_m - 1,
                              [f"Manufacturer#{m}" for m in range(1, 6)]),
        "p_brand": categorical((brand_m - 1) * 5 + (brand_n - 1),
                               [f"Brand#{m}{n}" for m in range(1, 6)
                                for n in range(1, 6)]),
        "p_type": categorical((t1 * 5 + t2) * 5 + t3, types),
        "p_size": p_size,
        "p_container": categorical(c1 * 8 + c2, containers),
        "p_retailprice": np.round(
            (90000 + pk % 20001 + 100 * (pk % 1000)) / 100.0, 2)}

    i = np.repeat(np.arange(4), n_part)
    psp = np.tile(pk, 4)
    s = np.int64(n_supp)
    ps_supp = ((psp + i * (s // 4 + (psp - 1) // s)) % s + 1).astype(np.int64)
    db["partsupp"] = {
        "ps_partkey": psp,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10000, 4 * n_part).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, 4 * n_part), 2)}

    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nation = rng.integers(0, 25, n_cust).astype(np.int64)
    db["customer"] = {
        "c_custkey": ck,
        "c_name": _numbered("Customer#", ck),
        "c_address": _modulo("addrC", ck, 997),
        "c_nationkey": c_nation,
        "c_phone": _phones(rng, c_nation),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": categorical(rng.integers(0, 5, n_cust), SEGMENTS)}

    # orders: only customers with custkey % 3 != 0 order (spec)
    ok = np.arange(1, n_ord + 1, dtype=np.int64)
    eligible = ck[ck % 3 != 0]
    o_cust = eligible[rng.integers(0, len(eligible), n_ord)]
    o_date = rng.integers(DATE_MIN, DATE_MAX - 151, n_ord).astype(np.int32)
    o_comments = _comment_vocab(rng, 1000, _O_PHRASE, 0.05)
    db["orders"] = {
        "o_orderkey": ok,
        "o_custkey": o_cust,
        "o_orderdate": o_date.astype(np.int64),
        "o_orderpriority": categorical(rng.integers(0, 5, n_ord),
                                       PRIORITIES),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": categorical(rng.integers(0, len(o_comments), n_ord),
                                 o_comments)}

    per_order = rng.integers(1, 8, n_ord)
    n_li = int(per_order.sum())
    l_order = np.repeat(ok, per_order)
    l_odate = np.repeat(o_date, per_order).astype(np.int64)
    ps_row = rng.integers(0, 4 * n_part, n_li)
    l_part = psp[ps_row]
    l_supp = ps_supp[ps_row]
    l_qty = rng.integers(1, 51, n_li).astype(np.int64)
    retail = ((90000 + pk % 20001 + 100 * (pk % 1000)) / 100.0)[l_part - 1]
    l_ship = l_odate + rng.integers(1, 122, n_li)
    l_commit = l_odate + rng.integers(30, 91, n_li)
    l_receipt = l_ship + rng.integers(1, 31, n_li)
    cutoff = date("1995-06-17")
    # returnflag over ("A", "N", "R"): R or A (even odds) once received
    # by the cutoff, N after
    flag = np.where(l_receipt <= cutoff,
                    np.where(rng.random(n_li) < 0.5, 2, 0), 1)
    shipped = l_ship <= cutoff
    l_disc = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    l_tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    l_price = np.round(l_qty * retail, 2)
    db["lineitem"] = {
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_linenumber": _linenumbers(per_order),
        "l_quantity": l_qty,
        "l_extendedprice": l_price,
        "l_discount": l_disc,
        "l_tax": l_tax,
        "l_returnflag": categorical(flag, ["A", "N", "R"]),
        "l_linestatus": categorical(np.where(shipped, 0, 1), ["F", "O"]),
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_shipinstruct": categorical(rng.integers(0, 4, n_li), INSTRUCTS),
        "l_shipmode": categorical(rng.integers(0, 7, n_li), SHIPMODES)}

    # o_orderstatus: F if every line is F, O if every line is O, else P
    starts = np.cumsum(per_order) - per_order
    n_f = np.add.reduceat(shipped.astype(np.int64), starts)
    status = np.where(n_f == per_order, 0, np.where(n_f == 0, 1, 2))
    db["orders"]["o_orderstatus"] = categorical(status, ["F", "O", "P"])
    # o_totalprice: sum of extendedprice * (1 + tax) * (1 - discount)
    val = l_price * (1 + l_tax) * (1 - l_disc)
    db["orders"]["o_totalprice"] = np.round(np.add.reduceat(val, starts), 2)
    return db
