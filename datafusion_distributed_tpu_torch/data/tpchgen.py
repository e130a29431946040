"""Deterministic TPC-H data generator on numpy alone (port of the reference
`data/tpchgen.py`).

It makes exactly the reference generator's RNG calls in the same order, so
the same seed gives the same values; instead of pyarrow tables it returns
host columns (numpy arrays, strings as int32 codes into sorted
dictionaries) that `Table.from_numpy` uploads. The encoding equals what the
reference's Arrow path (`io/parquet.py arrow_to_host_columns`) produces:
each dictionary is the sorted set of the column's values and every column
carries an all-true validity mask.

Cardinalities at SF=1: region 5, nation 25, supplier 10k, customer 150k,
part 200k, partsupp 800k, orders 1.5M, lineitem ~6M.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from datafusion_distributed_tpu_torch.ops.table import (
    Dictionary,
    Table,
    round_up_pow2,
)
from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema

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
# P_NAME concatenates color words, as in the TPC-H spec (q9 / q20 filter on
# them)
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


@dataclass
class HostTable:
    """One generated table: host columns in schema order, strings already
    encoded as int32 codes into their sorted dictionaries."""

    schema: Schema
    data: dict
    dictionaries: dict

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.data.values())))

    def to_table(self, device=None) -> Table:
        n = self.num_rows
        validity = {f.name: np.ones(n, dtype=np.bool_)
                    for f in self.schema.fields}
        return Table.from_numpy(
            self.data, self.schema, capacity=round_up_pow2(max(n, 1)),
            validity=validity, dictionaries=self.dictionaries, device=device,
        )


class _TableBuilder:
    def __init__(self) -> None:
        self.fields: list = []
        self.data: dict = {}
        self.dicts: dict = {}

    def add(self, name: str, dtype: DataType, values) -> None:
        self.fields.append(Field(name, dtype, True))
        self.data[name] = values

    def add_strings(self, name: str, values) -> None:
        """Encode against the sorted set of the column's values."""
        uniq, inverse = np.unique(np.asarray(values).astype(str),
                                  return_inverse=True)
        self.fields.append(Field(name, DataType.STRING, True))
        self.data[name] = inverse.astype(np.int32).reshape(-1)
        self.dicts[name] = Dictionary(uniq.astype(object))

    def add_choice(self, name: str, choices, idx) -> None:
        """Strings drawn as ``choices[idx]``, encoded without building the
        string column."""
        choices = np.asarray(choices, dtype=object)
        present = np.flatnonzero(np.bincount(np.asarray(idx),
                                             minlength=len(choices)))
        uniq = np.unique(choices[present].astype(str))
        lut = np.searchsorted(uniq, choices.astype(str)).astype(np.int32)
        self.fields.append(Field(name, DataType.STRING, True))
        self.data[name] = lut[np.asarray(idx)]
        self.dicts[name] = Dictionary(uniq.astype(object))

    def build(self) -> HostTable:
        return HostTable(Schema(self.fields), self.data, self.dicts)


def _dates(rng, n, lo=_EPOCH_1992, hi=_EPOCH_1998_AUG2):
    return rng.integers(lo, hi + 1, n).astype(np.int32)


def _comments(rng, n, max_words=8):
    """Space-joined comment words, built column-wise (the reference joins
    row by row; the strings are identical)."""
    k = rng.integers(2, max_words + 1, n)
    words = np.array(_COMMENT_WORDS)
    idx = rng.integers(0, len(words), (n, max_words))
    out = words[idx[:, 0]]
    for j in range(1, max_words):
        nxt = np.char.add(np.char.add(out, " "), words[idx[:, j]])
        out = np.where(j < k, nxt, out)
    return out


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
    in row order — the summation pandas' groupby sum performs."""
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


def gen_tpch(sf: float = 0.01, seed: int = 0) -> dict:
    """-> {table_name: HostTable} for all 8 TPC-H tables."""
    rng = np.random.default_rng(seed)

    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_part = max(int(200_000 * sf), 40)
    n_psupp = n_part * 4
    n_ord = max(int(1_500_000 * sf), 150)
    i64 = DataType.INT64

    b = _TableBuilder()
    b.add("r_regionkey", i64, np.arange(5, dtype=np.int64))
    b.add_strings("r_name", np.array(_REGIONS, dtype=object))
    b.add_strings("r_comment", _comments(rng, 5))
    region = b.build()

    b = _TableBuilder()
    b.add("n_nationkey", i64, np.arange(25, dtype=np.int64))
    b.add_strings("n_name", np.array([n for n, _ in _NATIONS], dtype=object))
    b.add("n_regionkey", i64, np.array([r for _, r in _NATIONS], dtype=np.int64))
    b.add_strings("n_comment", _comments(rng, 25))
    nation = b.build()

    s_nation = rng.integers(0, 25, n_supp)
    b = _TableBuilder()
    b.add("s_suppkey", i64, np.arange(1, n_supp + 1, dtype=np.int64))
    b.add_strings("s_name", np.array(
        [f"Supplier#{i:09d}" for i in range(1, n_supp + 1)], dtype=object))
    b.add_strings("s_address", _comments(rng, n_supp, 3))
    b.add("s_nationkey", i64, s_nation.astype(np.int64))
    b.add_strings("s_phone", _phones(rng, n_supp, s_nation))
    b.add("s_acctbal", DataType.FLOAT64,
          np.round(rng.uniform(-999.99, 9999.99, n_supp), 2))
    # TPC-H q16/q20 need "Customer Complaints" / special comments
    sup_comments = _comments(rng, n_supp).astype(object)
    sup_comments[0:n_supp:19] = "wake Customer slyly Complaints haggle"
    b.add_strings("s_comment", sup_comments)
    supplier = b.build()

    c_nation = rng.integers(0, 25, n_cust)
    b = _TableBuilder()
    b.add("c_custkey", i64, np.arange(1, n_cust + 1, dtype=np.int64))
    b.add_strings("c_name", np.array(
        [f"Customer#{i:09d}" for i in range(1, n_cust + 1)], dtype=object))
    b.add_strings("c_address", _comments(rng, n_cust, 3))
    b.add("c_nationkey", i64, c_nation.astype(np.int64))
    b.add_strings("c_phone", _phones(rng, n_cust, c_nation))
    b.add("c_acctbal", DataType.FLOAT64,
          np.round(rng.uniform(-999.99, 9999.99, n_cust), 2))
    b.add_choice("c_mktsegment", _SEGMENTS, rng.integers(0, 5, n_cust))
    b.add_strings("c_comment", _comments(rng, n_cust))
    customer = b.build()

    p1 = rng.integers(0, len(_TYPES_P1), n_part)
    p2 = rng.integers(0, len(_TYPES_P2), n_part)
    p3 = rng.integers(0, len(_TYPES_P3), n_part)
    p_type = np.array(
        [f"{_TYPES_P1[a]} {_TYPES_P2[b]} {_TYPES_P3[c]}"
         for a, b, c in zip(p1, p2, p3)],
        dtype=object,
    )
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    c1 = rng.integers(0, len(_CONTAINERS_P1), n_part)
    c2 = rng.integers(0, len(_CONTAINERS_P2), n_part)
    b = _TableBuilder()
    b.add("p_partkey", i64, np.arange(1, n_part + 1, dtype=np.int64))
    b.add_strings("p_name", np.array(
        [" ".join(row) for row in np.array(_COLOR_WORDS, dtype=object)[
            rng.integers(0, len(_COLOR_WORDS), (n_part, 5))]],
        dtype=object,
    ))
    b.add_strings("p_mfgr", np.array(
        [f"Manufacturer#{m}" for m in brand_m], dtype=object))
    b.add_strings("p_brand", np.array(
        [f"Brand#{m}{n}" for m, n in zip(brand_m, brand_n)], dtype=object))
    b.add_strings("p_type", p_type)
    b.add("p_size", DataType.INT32, rng.integers(1, 51, n_part).astype(np.int32))
    b.add_strings("p_container", np.array(
        [f"{_CONTAINERS_P1[a]} {_CONTAINERS_P2[b]}" for a, b in zip(c1, c2)],
        dtype=object,
    ))
    b.add("p_retailprice", DataType.FLOAT64, np.round(
        900 + (np.arange(1, n_part + 1) % 1000) / 10
        + 100 * (np.arange(1, n_part + 1) % 10), 2))
    b.add_strings("p_comment", _comments(rng, n_part, 3))
    part = b.build()

    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    ps_supp = (
        (ps_part + (np.tile(np.arange(4), n_part) * (n_supp // 4 + 1)))
        % n_supp
    ) + 1
    b = _TableBuilder()
    b.add("ps_partkey", i64, ps_part)
    b.add("ps_suppkey", i64, ps_supp.astype(np.int64))
    b.add("ps_availqty", DataType.INT32,
          rng.integers(1, 10_000, n_psupp).astype(np.int32))
    b.add("ps_supplycost", DataType.FLOAT64,
          np.round(rng.uniform(1.0, 1000.0, n_psupp), 2))
    b.add_strings("ps_comment", _comments(rng, n_psupp))
    partsupp = b.build()

    o_cust = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
    o_date = _dates(rng, n_ord)
    lines_per_order = rng.integers(1, 8, n_ord)
    n_li = int(lines_per_order.sum())
    starts = np.cumsum(lines_per_order) - lines_per_order

    li_order = np.repeat(np.arange(1, n_ord + 1, dtype=np.int64), lines_per_order)
    li_odate = np.repeat(o_date, lines_per_order)
    li_linenumber = (
        np.arange(n_li) - np.repeat(starts, lines_per_order) + 1
    ).astype(np.int32)
    li_part = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    # supplier chosen among the 4 suppliers of that part (partsupp relation)
    which = rng.integers(0, 4, n_li)
    li_supp = ((li_part + which * (n_supp // 4 + 1)) % n_supp + 1).astype(np.int64)
    qty = rng.integers(1, 51, n_li).astype(np.float64)
    extprice = np.round(qty * (90000 + (li_part % 20001) + 100) / 100.0, 2)
    discount = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    shipdate = li_odate + rng.integers(1, 122, n_li)
    commitdate = li_odate + rng.integers(30, 91, n_li)
    receiptdate = shipdate + rng.integers(1, 31, n_li)
    today = 10452  # 1998-08-14-ish cutoff for status
    returnflag = np.where(
        receiptdate <= 10225,
        np.where(rng.random(n_li) < 0.5, 1, 0),  # R / A
        2,  # N
    )
    is_open = shipdate > today - 61
    b = _TableBuilder()
    b.add("l_orderkey", i64, li_order)
    b.add("l_partkey", i64, li_part)
    b.add("l_suppkey", i64, li_supp)
    b.add("l_linenumber", DataType.INT32, li_linenumber)
    b.add("l_quantity", DataType.FLOAT64, qty)
    b.add("l_extendedprice", DataType.FLOAT64, extprice)
    b.add("l_discount", DataType.FLOAT64, discount)
    b.add("l_tax", DataType.FLOAT64, tax)
    b.add_choice("l_returnflag", ["A", "R", "N"], returnflag)
    b.add_choice("l_linestatus", ["F", "O"], is_open.astype(np.int64))
    b.add("l_shipdate", DataType.DATE32, shipdate.astype(np.int32))
    b.add("l_commitdate", DataType.DATE32, commitdate.astype(np.int32))
    b.add("l_receiptdate", DataType.DATE32, receiptdate.astype(np.int32))
    b.add_choice("l_shipinstruct", _INSTRUCTIONS,
                 rng.integers(0, len(_INSTRUCTIONS), n_li))
    b.add_choice("l_shipmode", _SHIPMODES,
                 rng.integers(0, len(_SHIPMODES), n_li))
    b.add_strings("l_comment", _comments(rng, n_li, 4))
    lineitem = b.build()

    # order status/totalprice derived from lineitems (every order has >= 1)
    totalprice = np.round(
        _kahan_group_sums(extprice * (1 + tax), starts, lines_per_order), 2
    )
    any_open = np.logical_or.reduceat(is_open, starts)
    all_open = np.logical_and.reduceat(is_open, starts)
    status = np.where(all_open, 1, np.where(any_open, 2, 0))  # O / P / F

    b = _TableBuilder()
    b.add("o_orderkey", i64, np.arange(1, n_ord + 1, dtype=np.int64))
    b.add("o_custkey", i64, o_cust)
    b.add_choice("o_orderstatus", ["F", "O", "P"], status)
    b.add("o_totalprice", DataType.FLOAT64, totalprice)
    b.add("o_orderdate", DataType.DATE32, o_date)
    b.add_choice("o_orderpriority", _PRIORITIES, rng.integers(0, 5, n_ord))
    b.add_strings("o_clerk", np.array(
        [f"Clerk#{i:09d}"
         for i in rng.integers(1, max(n_supp // 10, 2), n_ord)],
        dtype=object,
    ))
    b.add("o_shippriority", DataType.INT32, np.zeros(n_ord, dtype=np.int32))
    # q13 needs 'special requests' patterns in o_comment
    oc = _comments(rng, n_ord).astype(object)
    oc[0:n_ord:17] = "blithely special foxes requests nag"
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


def register_tpch(ctx, sf: float = 0.01, seed: int = 0) -> dict:
    """Generate + register all TPC-H tables in a SessionContext (on its
    device); returns the HostTables."""
    tables = gen_tpch(sf, seed)
    for name, host in tables.items():
        ctx.register_table(name, host.to_table(ctx.device))
    return tables


def tables_from_reference(arrow_tables: dict, device=None) -> dict:
    """{name: pyarrow.Table} (as the reference generator returns them) ->
    {name: Table}, through the same Arrow decoding the reference applies."""
    from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table

    return {name: arrow_to_table(t, device=device)
            for name, t in arrow_tables.items()}
