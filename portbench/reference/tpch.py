"""Plain reference for the 22 TPC-H queries of `portbench/queries/tpch/`: one
function per query, over the tables that the benchmark's generator made
(never the port's tables), in PyTorch on ``ctx["device"]`` (the host's CPU
by default; the card once the program's state is freed).

Every float is float64 and every integer int64. Joins look rows up by key
(`_Index`), GROUP BY goes through `_rows.group`, and string predicates are
evaluated once per dictionary entry and gathered by code (the dictionaries
are sorted, so code order is string order). Each function returns the
expected-result record of `harness/compare.py`.

Where a query keeps or drops a row by comparing two computed floats (q11's
HAVING, q15's maximum), a row whose two sides lie within the float
tolerance ``ctx["rtol"]`` of each other is marked optional: a program that
computes in a narrower float may decide it either way, and the answer is
right both ways.

``ctx["round"]``, when given, rounds every float the query reads and every
float it computes (the control in a narrower precision). Imports nothing of
the port.
"""

from __future__ import annotations

import datetime
import re

import numpy as np
import torch

from reference._rows import count, distinct_count, group, result, total


def day(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def year(days: torch.Tensor) -> torch.Tensor:
    """The proleptic Gregorian year of days since 1970-01-01 (H. Hinnant's
    civil_from_days)."""
    z = days + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    return yoe + era * 400 + (mp >= 10).to(yoe.dtype)


class _Index:
    """Row lookup by an int64 key (unique in the build side)."""

    def __init__(self, keys: torch.Tensor) -> None:
        self.keys, self.order = torch.sort(keys)

    def rows(self, probe: torch.Tensor) -> torch.Tensor:
        """The build row of each probe key, or -1."""
        if not self.keys.numel():
            return torch.full_like(probe, -1)
        pos = torch.searchsorted(self.keys, probe).clamp(
            max=self.keys.numel() - 1)
        return torch.where(self.keys[pos] == probe, self.order[pos], -1)


class Tpch:
    def __init__(self, tables: dict, ctx: dict | None = None) -> None:
        self.tables = tables
        self.ctx = ctx or {}
        self.r = self.ctx.get("round") or (lambda x: x)
        self.dev = torch.device(self.ctx.get("device", "cpu"))
        self._index: dict = {}
        self._cols: dict = {}

    def __call__(self, table: str, name: str) -> torch.Tensor:
        if (table, name) not in self._cols:
            t = self.tables[table]
            v = torch.from_numpy(np.ascontiguousarray(t["columns"][name]))
            v = v.to(self.dev)
            if t["types"][name] == "float64":
                v = self.r(v.to(torch.float64))
            else:
                v = v.to(torch.int64)
            self._cols[table, name] = v
        return self._cols[table, name]

    def tensor(self, values, dtype=None) -> torch.Tensor:
        return torch.as_tensor(values, dtype=dtype, device=self.dev)

    def dict(self, table: str, name: str) -> np.ndarray:
        return self.tables[table]["dicts"][name]

    def where(self, table: str, name: str, fn) -> torch.Tensor:
        """``fn(string)`` of each row's value of a string column."""
        lut = self.tensor([bool(fn(s)) for s in
                           self.dict(table, name).tolist()])
        return lut[self(table, name)]

    def code(self, table: str, name: str, value: str) -> int:
        d = self.dict(table, name)
        i = int(np.searchsorted(d, value))
        return i if i < len(d) and d[i] == value else -1

    def string(self, table: str, name: str, codes, alias=None):
        return (alias or name, codes, self.dict(table, name))

    def index(self, table: str, key: str) -> _Index:
        if (table, key) not in self._index:
            self._index[table, key] = _Index(self(table, key))
        return self._index[table, key]

    def lookup(self, table: str, key: str, probe: torch.Tensor):
        return self.index(table, key).rows(probe)


def q1(t):
    r = t.r
    keep = t("lineitem", "l_shipdate") <= day("1998-09-02")

    def li(name):
        return t("lineitem", name)[keep]

    price, disc, tax, qty = (li("l_extendedprice"), li("l_discount"),
                             li("l_tax"), li("l_quantity"))
    inv, (flag, status) = group([li("l_returnflag"), li("l_linestatus")])
    g = flag.numel()
    n = count(inv, g)
    disc_price = r(price * r(1 - disc))
    charge = r(disc_price * r(1 + tax))
    sums = [r(total(inv, x, g)) for x in (qty, price, disc_price, charge)]
    avgs = [r(total(inv, x, g) / n) for x in (qty, price, disc)]
    return result([
        t.string("lineitem", "l_returnflag", flag),
        t.string("lineitem", "l_linestatus", status),
        ("sum_qty", sums[0], None), ("sum_base_price", sums[1], None),
        ("sum_disc_price", sums[2], None), ("sum_charge", sums[3], None),
        ("avg_qty", avgs[0], None), ("avg_price", avgs[1], None),
        ("avg_disc", avgs[2], None), ("count_order", n, None),
    ], [(0, False), (1, False)])


def _nations_in(t, region: str) -> torch.Tensor:
    """Bool per nation key: the nation lies in ``region``."""
    rk = t.code("region", "r_name", region)
    keep = t("region", "r_name") == rk
    regions = t("region", "r_regionkey")[keep]
    return torch.isin(t("nation", "n_regionkey"), regions)


def _nation_named(t, name: str) -> int:
    row = int(torch.nonzero(t("nation", "n_name")
                            == t.code("nation", "n_name", name))[0])
    return int(t("nation", "n_nationkey")[row])


def _nation_rows(t, keys: torch.Tensor) -> torch.Tensor:
    return t.lookup("nation", "n_nationkey", keys)


def q2(t):
    europe = _nations_in(t, "EUROPE")
    supp_ok = europe[_nation_rows(t, t("supplier", "s_nationkey"))]
    ps_supp = t.lookup("supplier", "s_suppkey", t("partsupp", "ps_suppkey"))
    ps_eu = supp_ok[ps_supp]
    ps_part = t("partsupp", "ps_partkey")
    cost = t("partsupp", "ps_supplycost")
    part_ok = ((t("part", "p_size") == 15)
               & t.where("part", "p_type", lambda s: s.endswith("BRASS")))
    ps_prow = t.lookup("part", "p_partkey", ps_part)
    inv, (pk,) = group([ps_part[ps_eu]])
    low = cost.new_full((pk.numel(),), float("inf"))
    low.scatter_reduce_(0, inv, cost[ps_eu], reduce="amin")
    best = torch.full_like(cost, float("nan"))
    best[ps_eu] = low[inv]
    keep = ps_eu & part_ok[ps_prow] & (cost == best)
    srow, prow = ps_supp[keep], ps_prow[keep]
    nrow = _nation_rows(t, t("supplier", "s_nationkey")[srow])
    return result([
        ("s_acctbal", t("supplier", "s_acctbal")[srow], None),
        t.string("supplier", "s_name", t("supplier", "s_name")[srow]),
        t.string("nation", "n_name", t("nation", "n_name")[nrow]),
        ("p_partkey", t("part", "p_partkey")[prow], None),
        t.string("part", "p_mfgr", t("part", "p_mfgr")[prow]),
        t.string("supplier", "s_address", t("supplier", "s_address")[srow]),
        t.string("supplier", "s_phone", t("supplier", "s_phone")[srow]),
        t.string("supplier", "s_comment", t("supplier", "s_comment")[srow]),
    ], [(0, True), (2, False), (1, False), (3, False)], limit=100)


def _sum(x: torch.Tensor) -> torch.Tensor:
    """SUM as a one-row column: NULL (NaN) over no rows."""
    return x.sum().reshape(1) if x.numel() else x.new_full((1,), float("nan"))


def _revenue(t, keep) -> torch.Tensor:
    return t.r(t("lineitem", "l_extendedprice")[keep]
               * t.r(1 - t("lineitem", "l_discount")[keep]))


def q3(t):
    seg = t("customer", "c_mktsegment") == t.code(
        "customer", "c_mktsegment", "BUILDING")
    cut = day("1995-03-15")
    orow = t.lookup("orders", "o_orderkey", t("lineitem", "l_orderkey"))
    crow = t.lookup("customer", "c_custkey", t("orders", "o_custkey"))
    o_ok = seg[crow] & (t("orders", "o_orderdate") < cut)
    keep = o_ok[orow] & (t("lineitem", "l_shipdate") > cut)
    inv, (ok,) = group([t("lineitem", "l_orderkey")[keep]])
    g = ok.numel()
    rows = t.lookup("orders", "o_orderkey", ok)
    return result([
        ("l_orderkey", ok, None),
        ("revenue", t.r(total(inv, _revenue(t, keep), g)), None),
        ("o_orderdate", t("orders", "o_orderdate")[rows], None),
        ("o_shippriority", t("orders", "o_shippriority")[rows], None),
    ], [(1, True), (2, False)], limit=10)


def q4(t):
    late = t("lineitem", "l_commitdate") < t("lineitem", "l_receiptdate")
    has = torch.zeros_like(t("orders", "o_orderkey"), dtype=torch.bool)
    has[t.lookup("orders", "o_orderkey", t("lineitem", "l_orderkey")[late])] \
        = True
    d = t("orders", "o_orderdate")
    keep = has & (d >= day("1993-07-01")) & (d < day("1993-10-01"))
    inv, (prio,) = group([t("orders", "o_orderpriority")[keep]])
    return result([t.string("orders", "o_orderpriority", prio),
                   ("order_count", count(inv, prio.numel()), None)],
                  [(0, False)])


def q5(t):
    asia = _nations_in(t, "ASIA")
    orow = t.lookup("orders", "o_orderkey", t("lineitem", "l_orderkey"))
    crow = t.lookup("customer", "c_custkey", t("orders", "o_custkey"))[orow]
    srow = t.lookup("supplier", "s_suppkey", t("lineitem", "l_suppkey"))
    c_nat = t("customer", "c_nationkey")[crow]
    s_nat = t("supplier", "s_nationkey")[srow]
    d = t("orders", "o_orderdate")[orow]
    keep = ((c_nat == s_nat) & asia[_nation_rows(t, s_nat)]
            & (d >= day("1994-01-01")) & (d < day("1995-01-01")))
    names = t("nation", "n_name")[_nation_rows(t, s_nat[keep])]
    inv, (name,) = group([names])
    return result([t.string("nation", "n_name", name),
                   ("revenue", t.r(total(inv, _revenue(t, keep),
                                         name.numel())), None)],
                  [(1, True)])


def q6(t):
    d, disc = t("lineitem", "l_shipdate"), t("lineitem", "l_discount")
    keep = ((d >= day("1994-01-01")) & (d < day("1995-01-01"))
            & (disc >= t.r(t.tensor(0.05, torch.float64)))
            & (disc <= t.r(t.tensor(0.07, torch.float64)))
            & (t("lineitem", "l_quantity") < 24))
    rev = t.r(t("lineitem", "l_extendedprice")[keep] * disc[keep])
    return result([("revenue", t.r(_sum(rev)), None)])


def q7(t):
    fr, de = _nation_named(t, "FRANCE"), _nation_named(t, "GERMANY")
    orow = t.lookup("orders", "o_orderkey", t("lineitem", "l_orderkey"))
    crow = t.lookup("customer", "c_custkey", t("orders", "o_custkey"))[orow]
    srow = t.lookup("supplier", "s_suppkey", t("lineitem", "l_suppkey"))
    sn = t("supplier", "s_nationkey")[srow]
    cn = t("customer", "c_nationkey")[crow]
    d = t("lineitem", "l_shipdate")
    keep = ((((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr)))
            & (d >= day("1995-01-01")) & (d <= day("1996-12-31")))
    sname = t("nation", "n_name")[_nation_rows(t, sn[keep])]
    cname = t("nation", "n_name")[_nation_rows(t, cn[keep])]
    inv, (a, b, y) = group([sname, cname, year(d[keep])])
    return result([
        t.string("nation", "n_name", a, "supp_nation"),
        t.string("nation", "n_name", b, "cust_nation"),
        ("l_year", y, None),
        ("revenue", t.r(total(inv, _revenue(t, keep), a.numel())), None),
    ], [(0, False), (1, False), (2, False)])


def q8(t):
    america = _nations_in(t, "AMERICA")
    brazil = _nation_named(t, "BRAZIL")
    ptype = t("part", "p_type") == t.code("part", "p_type",
                                          "ECONOMY ANODIZED STEEL")
    prow = t.lookup("part", "p_partkey", t("lineitem", "l_partkey"))
    orow = t.lookup("orders", "o_orderkey", t("lineitem", "l_orderkey"))
    crow = t.lookup("customer", "c_custkey", t("orders", "o_custkey"))[orow]
    srow = t.lookup("supplier", "s_suppkey", t("lineitem", "l_suppkey"))
    od = t("orders", "o_orderdate")[orow]
    keep = (ptype[prow]
            & america[_nation_rows(t, t("customer", "c_nationkey")[crow])]
            & (od >= day("1995-01-01")) & (od <= day("1996-12-31")))
    vol = _revenue(t, keep)
    is_br = t("supplier", "s_nationkey")[srow][keep] == brazil
    inv, (y,) = group([year(od[keep])])
    g = y.numel()
    share = t.r(t.r(total(inv, torch.where(is_br, vol, 0.0), g))
                / t.r(total(inv, vol, g)))
    return result([("o_year", y, None), ("mkt_share", share, None)],
                  [(0, False)])


def q9(t):
    green = t.where("part", "p_name", lambda s: "green" in s)
    lp, ls = t("lineitem", "l_partkey"), t("lineitem", "l_suppkey")
    keep = green[t.lookup("part", "p_partkey", lp)]
    span = int(t("partsupp", "ps_suppkey").max()) + 1
    ps = _Index(t("partsupp", "ps_partkey") * span
                + t("partsupp", "ps_suppkey"))
    psrow = ps.rows(lp[keep] * span + ls[keep])
    cost = t("partsupp", "ps_supplycost")[psrow]
    amount = t.r(_revenue(t, keep)
                 - t.r(cost * t("lineitem", "l_quantity")[keep]))
    srow = t.lookup("supplier", "s_suppkey", ls[keep])
    nation = t("nation", "n_name")[
        _nation_rows(t, t("supplier", "s_nationkey")[srow])]
    orow = t.lookup("orders", "o_orderkey", t("lineitem", "l_orderkey")[keep])
    inv, (n, y) = group([nation, year(t("orders", "o_orderdate")[orow])])
    return result([t.string("nation", "n_name", n, "nation"),
                   ("o_year", y, None),
                   ("sum_profit", t.r(total(inv, amount, n.numel())), None)],
                  [(0, False), (1, True)])


def q10(t):
    od = t("orders", "o_orderdate")
    o_ok = (od >= day("1993-10-01")) & (od < day("1994-01-01"))
    orow = t.lookup("orders", "o_orderkey", t("lineitem", "l_orderkey"))
    keep = o_ok[orow] & (t("lineitem", "l_returnflag") == t.code(
        "lineitem", "l_returnflag", "R"))
    inv, (ck,) = group([t("orders", "o_custkey")[orow[keep]]])
    crow = t.lookup("customer", "c_custkey", ck)
    nrow = _nation_rows(t, t("customer", "c_nationkey")[crow])

    def c(name):
        return t.string("customer", name, t("customer", name)[crow])

    return result([
        ("c_custkey", ck, None), c("c_name"),
        ("revenue", t.r(total(inv, _revenue(t, keep), ck.numel())), None),
        ("c_acctbal", t("customer", "c_acctbal")[crow], None),
        t.string("nation", "n_name", t("nation", "n_name")[nrow]),
        c("c_address"), c("c_phone"), c("c_comment"),
    ], [(2, True)], limit=20)


def q11(t):
    de = _nation_named(t, "GERMANY")
    srow = t.lookup("supplier", "s_suppkey", t("partsupp", "ps_suppkey"))
    keep = t("supplier", "s_nationkey")[srow] == de
    value = t.r(t("partsupp", "ps_supplycost")[keep]
                * t("partsupp", "ps_availqty")[keep])
    inv, (pk,) = group([t("partsupp", "ps_partkey")[keep]])
    sums = t.r(total(inv, value, pk.numel()))
    thr = float(t.r(t.r(value.sum()) * 0.0001))
    band = t.ctx.get("rtol", 0.0) * abs(thr)
    shown = sums > thr - band
    optional = (sums - thr).abs() <= band
    return result([("ps_partkey", pk[shown], None),
                   ("value", sums[shown], None)], [(1, True)],
                  optional=optional[shown])


def q12(t):
    mode = t("lineitem", "l_shipmode")
    mail, ship = (t.code("lineitem", "l_shipmode", m) for m in ("MAIL", "SHIP"))
    cd, rd, sd = (t("lineitem", c) for c in
                  ("l_commitdate", "l_receiptdate", "l_shipdate"))
    keep = (((mode == mail) | (mode == ship)) & (cd < rd) & (sd < cd)
            & (rd >= day("1994-01-01")) & (rd < day("1995-01-01")))
    orow = t.lookup("orders", "o_orderkey", t("lineitem", "l_orderkey")[keep])
    high = t.where("orders", "o_orderpriority",
                   lambda s: s in ("1-URGENT", "2-HIGH"))[orow]
    inv, (m,) = group([mode[keep]])
    g = m.numel()
    return result([t.string("lineitem", "l_shipmode", m),
                   ("high_line_count", total(inv, high.to(torch.int64), g),
                    None),
                   ("low_line_count", total(inv, (~high).to(torch.int64), g),
                    None)], [(0, False)])


def q13(t):
    special = re.compile("special.*requests", re.S)
    plain = ~t.where("orders", "o_comment",
                     lambda s: special.search(s) is not None)
    crow = t.lookup("customer", "c_custkey", t("orders", "o_custkey")[plain])
    n_cust = t("customer", "c_custkey").numel()
    per_cust = torch.bincount(crow, minlength=n_cust).to(torch.int64)
    inv, (c,) = group([per_cust])
    return result([("c_count", c, None),
                   ("custdist", count(inv, c.numel()), None)],
                  [(1, True), (0, True)])


def q14(t):
    d = t("lineitem", "l_shipdate")
    keep = (d >= day("1995-09-01")) & (d < day("1995-10-01"))
    promo = t.where("part", "p_type", lambda s: s.startswith("PROMO"))[
        t.lookup("part", "p_partkey", t("lineitem", "l_partkey")[keep])]
    vol = _revenue(t, keep)
    share = t.r(t.r(100.0 * t.r(_sum(torch.where(promo, vol, 0.0))))
                / t.r(_sum(vol)))
    return result([("promo_revenue", share, None)])


def q15(t):
    d = t("lineitem", "l_shipdate")
    keep = (d >= day("1996-01-01")) & (d < day("1996-04-01"))
    inv, (sk,) = group([t("lineitem", "l_suppkey")[keep]])
    rev = t.r(total(inv, _revenue(t, keep), sk.numel()))
    top = float(rev.max())
    band = t.ctx.get("rtol", 0.0) * abs(top)
    shown = rev >= top - band
    srow = t.lookup("supplier", "s_suppkey", sk[shown])

    def s(name):
        return t.string("supplier", name, t("supplier", name)[srow])

    optional = t.tensor([bool(shown.sum() > 1)] * int(shown.sum()))
    return result([("s_suppkey", sk[shown], None), s("s_name"),
                   s("s_address"), s("s_phone"),
                   ("total_revenue", rev[shown], None)], [(0, False)],
                  optional=optional, min_rows=1)


def q16(t):
    bad_supp = t.where("supplier", "s_comment",
                       lambda s: re.search("Customer.*Complaints", s, re.S))
    sizes = t.tensor([49, 14, 23, 45, 19, 3, 36, 9])
    part_ok = ((t("part", "p_brand") != t.code("part", "p_brand", "Brand#45"))
               & ~t.where("part", "p_type",
                          lambda s: s.startswith("MEDIUM POLISHED"))
               & torch.isin(t("part", "p_size"), sizes))
    prow = t.lookup("part", "p_partkey", t("partsupp", "ps_partkey"))
    srow = t.lookup("supplier", "s_suppkey", t("partsupp", "ps_suppkey"))
    keep = part_ok[prow] & ~bad_supp[srow]
    p = prow[keep]
    inv, (brand, ptype, size) = group([t("part", "p_brand")[p],
                                       t("part", "p_type")[p],
                                       t("part", "p_size")[p]])
    return result([
        t.string("part", "p_brand", brand), t.string("part", "p_type", ptype),
        ("p_size", size, None),
        ("supplier_cnt", distinct_count(inv, t("partsupp", "ps_suppkey")[keep],
                                        brand.numel()), None),
    ], [(3, True), (0, False), (1, False), (2, False)])


def q17(t):
    part_ok = ((t("part", "p_brand") == t.code("part", "p_brand", "Brand#23"))
               & (t("part", "p_container")
                  == t.code("part", "p_container", "MED BOX")))
    prow = t.lookup("part", "p_partkey", t("lineitem", "l_partkey"))
    qty = t("lineitem", "l_quantity")
    n_part = t("part", "p_partkey").numel()
    avg = t.r(total(prow, qty, n_part)
              / torch.bincount(prow, minlength=n_part).to(torch.float64))
    keep = part_ok[prow] & (qty < t.r(0.2 * avg[prow]))
    value = t.r(t.r(_sum(t("lineitem", "l_extendedprice")[keep])) / 7.0)
    return result([("avg_yearly", value, None)])


def q18(t):
    lo = t("lineitem", "l_orderkey")
    qty = t("lineitem", "l_quantity")
    orow = t.lookup("orders", "o_orderkey", lo)
    n_ord = t("orders", "o_orderkey").numel()
    per_order = total(orow, qty, n_ord)
    big = torch.nonzero(per_order > 300).flatten()
    crow = t.lookup("customer", "c_custkey", t("orders", "o_custkey")[big])
    return result([
        t.string("customer", "c_name", t("customer", "c_name")[crow]),
        ("c_custkey", t("customer", "c_custkey")[crow], None),
        ("o_orderkey", t("orders", "o_orderkey")[big], None),
        ("o_orderdate", t("orders", "o_orderdate")[big], None),
        ("o_totalprice", t("orders", "o_totalprice")[big], None),
        (None, t.r(per_order[big]), None),
    ], [(4, True), (3, False)], limit=100)


def q19(t):
    prow = t.lookup("part", "p_partkey", t("lineitem", "l_partkey"))
    brand, cont, size = (t("part", c)[prow] for c in
                         ("p_brand", "p_container", "p_size"))
    qty = t("lineitem", "l_quantity")
    mode_ok = torch.isin(t("lineitem", "l_shipmode"), t.tensor(
        [t.code("lineitem", "l_shipmode", m) for m in ("AIR", "AIR REG")]))
    instr_ok = t("lineitem", "l_shipinstruct") == t.code(
        "lineitem", "l_shipinstruct", "DELIVER IN PERSON")

    def arm(b, containers, q_lo, q_hi, s_hi):
        conts = t.tensor([t.code("part", "p_container", c)
                          for c in containers])
        return ((brand == t.code("part", "p_brand", b))
                & torch.isin(cont, conts) & (qty >= q_lo) & (qty <= q_hi)
                & (size >= 1) & (size <= s_hi))

    keep = mode_ok & instr_ok & (
        arm("Brand#12", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"], 1, 11, 5)
        | arm("Brand#23", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"],
              10, 20, 10)
        | arm("Brand#34", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"],
              20, 30, 15))
    return result([("revenue", t.r(_sum(_revenue(t, keep))), None)])


def q20(t):
    forest = t.where("part", "p_name", lambda s: s.startswith("forest"))
    d = t("lineitem", "l_shipdate")
    keep = (d >= day("1994-01-01")) & (d < day("1995-01-01"))
    span = int(t("partsupp", "ps_suppkey").max()) + 1
    pskey = t("partsupp", "ps_partkey") * span + t("partsupp", "ps_suppkey")
    psrow = _Index(pskey).rows(t("lineitem", "l_partkey")[keep] * span
                               + t("lineitem", "l_suppkey")[keep])
    found = psrow >= 0
    n_ps = pskey.numel()
    qty_sum = total(psrow[found], t("lineitem", "l_quantity")[keep][found],
                    n_ps)
    lines = torch.bincount(psrow[found], minlength=n_ps)
    ps_ok = (forest[t.lookup("part", "p_partkey", t("partsupp", "ps_partkey"))]
             & (lines > 0)
             & (t("partsupp", "ps_availqty") > t.r(0.5 * qty_sum)))
    supp = torch.unique(t("partsupp", "ps_suppkey")[ps_ok])
    ca = _nation_named(t, "CANADA")
    srow = t.lookup("supplier", "s_suppkey", supp)
    srow = srow[t("supplier", "s_nationkey")[srow] == ca]
    return result([
        t.string("supplier", "s_name", t("supplier", "s_name")[srow]),
        t.string("supplier", "s_address", t("supplier", "s_address")[srow]),
    ], [(0, False)])


def q21(t):
    sa = _nation_named(t, "SAUDI ARABIA")
    ok, sk = t("lineitem", "l_orderkey"), t("lineitem", "l_suppkey")
    late = t("lineitem", "l_receiptdate") > t("lineitem", "l_commitdate")
    orow = t.lookup("orders", "o_orderkey", ok)
    n_ord = t("orders", "o_orderkey").numel()
    # distinct suppliers of each order, and distinct late suppliers
    _inv, (po, _ps) = group([orow, sk])
    suppliers = torch.bincount(po, minlength=n_ord)
    _inv, (lo, _ls) = group([orow[late], sk[late]])
    late_suppliers = torch.bincount(lo, minlength=n_ord)
    status_f = t("orders", "o_orderstatus") == t.code(
        "orders", "o_orderstatus", "F")
    srow = t.lookup("supplier", "s_suppkey", sk)
    keep = (late & status_f[orow] & (suppliers[orow] > 1)
            & (late_suppliers[orow] == 1)
            & (t("supplier", "s_nationkey")[srow] == sa))
    inv, (name,) = group([t("supplier", "s_name")[srow[keep]]])
    return result([t.string("supplier", "s_name", name),
                   ("numwait", count(inv, name.numel()), None)],
                  [(1, True), (0, False)], limit=100)


def q22(t):
    codes = ("13", "31", "23", "29", "30", "18", "17")
    prefix = t.where("customer", "c_phone", lambda s: s[:2] in codes)
    bal = t("customer", "c_acctbal")
    pos = prefix & (bal > 0.0)
    avg = t.r(t.r(bal[pos].sum()) / pos.sum())
    has_order = torch.zeros_like(bal, dtype=torch.bool)
    has_order[t.lookup("customer", "c_custkey", t("orders", "o_custkey"))] \
        = True
    keep = prefix & (bal > avg) & ~has_order
    phones = t.dict("customer", "c_phone")
    cc = np.array([s[:2] for s in phones[t("customer", "c_phone")[keep]
                                          .cpu().numpy()]], dtype=object)
    cdict = np.unique(np.asarray(codes, dtype=str))
    ccode = t.tensor(np.searchsorted(cdict, cc.astype(str)), torch.int64)
    inv, (c,) = group([ccode])
    g = c.numel()
    return result([("cntrycode", c, cdict),
                   ("numcust", count(inv, g), None),
                   ("totacctbal", t.r(total(inv, bal[keep], g)), None)],
                  [(0, False)])


QUERIES = {f"q{i}": globals()[f"q{i}"] for i in range(1, 23)}


def prepare(tables: dict, ctx: dict | None = None) -> Tpch:
    return Tpch(tables, ctx)
