"""TPC-H tables from a seed, as plain numpy columns (frozen copy of the
port's `data/tpchgen.py`).

It makes exactly the same numpy RNG calls in the same order, so a seed gives
the same values as the port's generator, and it encodes every string column
the same way: int32 codes into the sorted set of the column's values. What
differs is only how the strings are built: a comment is a sequence of words,
so each row's sequence is first coded as one integer, the distinct codes are
found with `np.unique` on integers, and strings are built only for those.
That gives the same codes and dictionaries in a fraction of the time
(`portbench/tests/test_portbench_generators.py` holds the two equal).

`generate(scale, seed)` returns ``{table: {"columns": {name: array},
"types": {name: type}, "dicts": {name: sorted str array}}}`` with the types
``int64``, ``int32``, ``float64``, ``date32`` (days since 1970) and
``string`` (int32 codes). Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_INSTRUCTIONS = [
    "COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN",
]
_TYPES_P1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPES_P2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPES_P3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_CONTAINERS_P1 = ["SM", "MED", "JUMBO", "WRAP", "LG"]
_CONTAINERS_P2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
_COMMENT_WORDS = (
    "the of and regular deposits carefully quickly furiously final special "
    "express ironic pending bold slyly blithely even silent unusual requests "
    "accounts packages theodolites foxes ideas dependencies instructions "
    "platelets pinto beans sleep haggle nag use wake cajole detect integrate"
).split()
_COLOR_WORDS = (
    "almond antique aquamarine azure beige bisque black blanched blue "
    "blush brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder "
    "puff purple red rose rosy royal saddle salmon sandy seashell sienna "
    "sky slate smoke snow spring steel tan thistle tomato turquoise "
    "violet wheat white yellow"
).split()

_EPOCH_1992 = 8035  # days 1970-01-01 -> 1992-01-01
_EPOCH_1998_AUG2 = 10440  # last possible o_orderdate (1998-08-02)


class _Strings:
    """A string column held as integer codes of its values plus a function
    that renders a code as its string."""

    def __init__(self, codes: np.ndarray, render) -> None:
        self.codes = codes
        self.render = render


class _Builder:
    def __init__(self) -> None:
        self.columns: dict = {}
        self.types: dict = {}
        self.dicts: dict = {}

    def add(self, name: str, kind: str, values) -> None:
        self.columns[name] = np.asarray(values)
        self.types[name] = kind

    def add_strings(self, name: str, values) -> None:
        """Encode against the sorted set of the column's values."""
        if isinstance(values, _Strings):
            uniq, inverse = np.unique(values.codes, return_inverse=True)
            strs = np.array([values.render(int(c)) for c in uniq], dtype=str)
            # two codes may render alike (an overwriting string made of
            # comment words): the dictionary is of strings
            values, rank = np.unique(strs, return_inverse=True)
            codes = rank.reshape(-1)[inverse.reshape(-1)]
        else:
            values, codes = np.unique(np.asarray(values).astype(str),
                                      return_inverse=True)
        self.columns[name] = codes.astype(np.int32).reshape(-1)
        self.types[name] = "string"
        self.dicts[name] = values

    def add_choice(self, name: str, choices, idx) -> None:
        """Strings drawn as ``choices[idx]``; the dictionary holds the
        choices present."""
        choices = np.asarray(choices, dtype=object)
        idx = np.asarray(idx)
        present = np.flatnonzero(np.bincount(idx, minlength=len(choices)))
        uniq = np.unique(choices[present].astype(str))
        lut = np.searchsorted(uniq, choices.astype(str)).astype(np.int32)
        self.columns[name] = lut[idx]
        self.types[name] = "string"
        self.dicts[name] = uniq

    def build(self) -> dict:
        return {"columns": self.columns, "types": self.types,
                "dicts": self.dicts}


def _dates(rng, n, lo=_EPOCH_1992, hi=_EPOCH_1998_AUG2):
    return rng.integers(lo, hi + 1, n).astype(np.int32)


def _comments(rng, n, max_words=8, extra=None) -> _Strings:
    """Space-joined comment words: row r is the first k_r of its drawn
    words. Coded as base-64 digits (word index + 1), lowest digit first;
    ``extra`` maps codes below 0 to fixed strings that overwrite rows."""
    k = rng.integers(2, max_words + 1, n)
    idx = rng.integers(0, len(_COMMENT_WORDS), (n, max_words))
    code = np.zeros(n, dtype=np.int64)
    for j in range(max_words - 1, -1, -1):
        code = np.where(j < k, code * 64 + idx[:, j] + 1, code)
    fixed = extra or {}

    def render(c: int) -> str:
        if c < 0:
            return fixed[c]
        words = []
        while c:
            words.append(_COMMENT_WORDS[c % 64 - 1])
            c //= 64
        return " ".join(words)

    return _Strings(code, render)


def _phones(rng, n, nation_keys):
    a = nation_keys.astype(np.int64) + 10
    b = rng.integers(100, 1000, n)
    c = rng.integers(100, 1000, n)
    d = rng.integers(1000, 10000, n)
    return np.array(
        [f"{ai}-{bi}-{ci}-{di}" for ai, bi, ci, di in zip(a, b, c, d)],
        dtype=object,
    )


def _kahan_group_sums(values, starts, counts):
    """Per-group float64 sums of contiguous groups with Kahan compensation,
    in row order."""
    total = np.zeros(len(starts), dtype=np.float64)
    comp = np.zeros(len(starts), dtype=np.float64)
    for j in range(int(counts.max()) if len(counts) else 0):
        sel = counts > j
        val = values[starts[sel] + j]
        y = val - comp[sel]
        t = total[sel] + y
        comp[sel] = (t - total[sel]) - y
        total[sel] = t
    return total


def _numbered(prefix: str, numbers) -> _Strings:
    return _Strings(np.asarray(numbers, dtype=np.int64),
                    lambda c: f"{prefix}{c:09d}")


def generate(scale: float = 0.01, seed: int = 0) -> dict:
    """-> {table_name: {"columns", "types", "dicts"}} for all 8 tables."""
    rng = np.random.default_rng(seed)
    sf = scale

    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_part = max(int(200_000 * sf), 40)
    n_psupp = n_part * 4
    n_ord = max(int(1_500_000 * sf), 150)

    b = _Builder()
    b.add("r_regionkey", "int64", np.arange(5, dtype=np.int64))
    b.add_strings("r_name", np.array(_REGIONS, dtype=object))
    b.add_strings("r_comment", _comments(rng, 5))
    region = b.build()

    b = _Builder()
    b.add("n_nationkey", "int64", np.arange(25, dtype=np.int64))
    b.add_strings("n_name", np.array([n for n, _ in _NATIONS], dtype=object))
    b.add("n_regionkey", "int64",
          np.array([r for _, r in _NATIONS], dtype=np.int64))
    b.add_strings("n_comment", _comments(rng, 25))
    nation = b.build()

    s_nation = rng.integers(0, 25, n_supp)
    b = _Builder()
    b.add("s_suppkey", "int64", np.arange(1, n_supp + 1, dtype=np.int64))
    b.add_strings("s_name", _numbered("Supplier#", np.arange(1, n_supp + 1)))
    b.add_strings("s_address", _comments(rng, n_supp, 3))
    b.add("s_nationkey", "int64", s_nation.astype(np.int64))
    b.add_strings("s_phone", _phones(rng, n_supp, s_nation))
    b.add("s_acctbal", "float64",
          np.round(rng.uniform(-999.99, 9999.99, n_supp), 2))
    # q16 and q20 need "Customer Complaints" among the supplier comments
    sup = _comments(rng, n_supp,
                    extra={-1: "wake Customer slyly Complaints haggle"})
    sup.codes[0:n_supp:19] = -1
    b.add_strings("s_comment", sup)
    supplier = b.build()

    c_nation = rng.integers(0, 25, n_cust)
    b = _Builder()
    b.add("c_custkey", "int64", np.arange(1, n_cust + 1, dtype=np.int64))
    b.add_strings("c_name", _numbered("Customer#", np.arange(1, n_cust + 1)))
    b.add_strings("c_address", _comments(rng, n_cust, 3))
    b.add("c_nationkey", "int64", c_nation.astype(np.int64))
    b.add_strings("c_phone", _phones(rng, n_cust, c_nation))
    b.add("c_acctbal", "float64",
          np.round(rng.uniform(-999.99, 9999.99, n_cust), 2))
    b.add_choice("c_mktsegment", _SEGMENTS, rng.integers(0, 5, n_cust))
    b.add_strings("c_comment", _comments(rng, n_cust))
    customer = b.build()

    p1 = rng.integers(0, len(_TYPES_P1), n_part)
    p2 = rng.integers(0, len(_TYPES_P2), n_part)
    p3 = rng.integers(0, len(_TYPES_P3), n_part)
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    c1 = rng.integers(0, len(_CONTAINERS_P1), n_part)
    c2 = rng.integers(0, len(_CONTAINERS_P2), n_part)
    b = _Builder()
    b.add("p_partkey", "int64", np.arange(1, n_part + 1, dtype=np.int64))
    colors = rng.integers(0, len(_COLOR_WORDS), (n_part, 5))
    b.add_strings("p_name", _Strings(
        (colors * (128 ** np.arange(5))).sum(axis=1),
        lambda c: " ".join(_COLOR_WORDS[(c >> (7 * j)) & 127]
                           for j in range(5))))
    b.add_strings("p_mfgr", _Strings(brand_m, lambda c: f"Manufacturer#{c}"))
    b.add_strings("p_brand", _Strings(brand_m * 10 + brand_n,
                                      lambda c: f"Brand#{c}"))
    b.add_strings("p_type", _Strings(
        (p1 * 8 + p2) * 8 + p3,
        lambda c: f"{_TYPES_P1[c // 64]} {_TYPES_P2[c // 8 % 8]} "
                  f"{_TYPES_P3[c % 8]}"))
    b.add("p_size", "int32", rng.integers(1, 51, n_part).astype(np.int32))
    b.add_strings("p_container", _Strings(
        c1 * 8 + c2,
        lambda c: f"{_CONTAINERS_P1[c // 8]} {_CONTAINERS_P2[c % 8]}"))
    b.add("p_retailprice", "float64", np.round(
        900 + (np.arange(1, n_part + 1) % 1000) / 10
        + 100 * (np.arange(1, n_part + 1) % 10), 2))
    b.add_strings("p_comment", _comments(rng, n_part, 3))
    part = b.build()

    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    ps_supp = (
        (ps_part + (np.tile(np.arange(4), n_part) * (n_supp // 4 + 1)))
        % n_supp
    ) + 1
    b = _Builder()
    b.add("ps_partkey", "int64", ps_part)
    b.add("ps_suppkey", "int64", ps_supp.astype(np.int64))
    b.add("ps_availqty", "int32",
          rng.integers(1, 10_000, n_psupp).astype(np.int32))
    b.add("ps_supplycost", "float64",
          np.round(rng.uniform(1.0, 1000.0, n_psupp), 2))
    b.add_strings("ps_comment", _comments(rng, n_psupp))
    partsupp = b.build()

    o_cust = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
    o_date = _dates(rng, n_ord)
    lines_per_order = rng.integers(1, 8, n_ord)
    n_li = int(lines_per_order.sum())
    starts = np.cumsum(lines_per_order) - lines_per_order

    li_order = np.repeat(np.arange(1, n_ord + 1, dtype=np.int64),
                         lines_per_order)
    li_odate = np.repeat(o_date, lines_per_order)
    li_linenumber = (
        np.arange(n_li) - np.repeat(starts, lines_per_order) + 1
    ).astype(np.int32)
    li_part = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    # the supplier is one of the 4 suppliers of that part (partsupp)
    which = rng.integers(0, 4, n_li)
    li_supp = ((li_part + which * (n_supp // 4 + 1)) % n_supp
               + 1).astype(np.int64)
    qty = rng.integers(1, 51, n_li).astype(np.float64)
    extprice = np.round(qty * (90000 + (li_part % 20001) + 100) / 100.0, 2)
    discount = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    shipdate = li_odate + rng.integers(1, 122, n_li)
    commitdate = li_odate + rng.integers(30, 91, n_li)
    receiptdate = shipdate + rng.integers(1, 31, n_li)
    today = 10452  # the cut-off that decides the line status
    returnflag = np.where(
        receiptdate <= 10225,
        np.where(rng.random(n_li) < 0.5, 1, 0),  # R / A
        2,  # N
    )
    is_open = shipdate > today - 61
    b = _Builder()
    b.add("l_orderkey", "int64", li_order)
    b.add("l_partkey", "int64", li_part)
    b.add("l_suppkey", "int64", li_supp)
    b.add("l_linenumber", "int32", li_linenumber)
    b.add("l_quantity", "float64", qty)
    b.add("l_extendedprice", "float64", extprice)
    b.add("l_discount", "float64", discount)
    b.add("l_tax", "float64", tax)
    b.add_choice("l_returnflag", ["A", "R", "N"], returnflag)
    b.add_choice("l_linestatus", ["F", "O"], is_open.astype(np.int64))
    b.add("l_shipdate", "date32", shipdate.astype(np.int32))
    b.add("l_commitdate", "date32", commitdate.astype(np.int32))
    b.add("l_receiptdate", "date32", receiptdate.astype(np.int32))
    b.add_choice("l_shipinstruct", _INSTRUCTIONS,
                 rng.integers(0, len(_INSTRUCTIONS), n_li))
    b.add_choice("l_shipmode", _SHIPMODES,
                 rng.integers(0, len(_SHIPMODES), n_li))
    b.add_strings("l_comment", _comments(rng, n_li, 4))
    lineitem = b.build()

    # order status and total price follow from the lines (every order has
    # at least one)
    totalprice = np.round(
        _kahan_group_sums(extprice * (1 + tax), starts, lines_per_order), 2
    )
    any_open = np.logical_or.reduceat(is_open, starts)
    all_open = np.logical_and.reduceat(is_open, starts)
    status = np.where(all_open, 1, np.where(any_open, 2, 0))  # O / P / F

    b = _Builder()
    b.add("o_orderkey", "int64", np.arange(1, n_ord + 1, dtype=np.int64))
    b.add("o_custkey", "int64", o_cust)
    b.add_choice("o_orderstatus", ["F", "O", "P"], status)
    b.add("o_totalprice", "float64", totalprice)
    b.add("o_orderdate", "date32", o_date)
    b.add_choice("o_orderpriority", _PRIORITIES, rng.integers(0, 5, n_ord))
    b.add_strings("o_clerk", _numbered(
        "Clerk#", rng.integers(1, max(n_supp // 10, 2), n_ord)))
    b.add("o_shippriority", "int32", np.zeros(n_ord, dtype=np.int32))
    # q13 needs 'special requests' among the order comments
    oc = _comments(rng, n_ord,
                   extra={-1: "blithely special foxes requests nag"})
    oc.codes[0:n_ord:17] = -1
    b.add_strings("o_comment", oc)
    orders = b.build()

    return {
        "region": region,
        "nation": nation,
        "supplier": supplier,
        "customer": customer,
        "part": part,
        "partsupp": partsupp,
        "orders": orders,
        "lineitem": lineitem,
    }
