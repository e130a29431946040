"""Plain reference for the 43 ClickBench queries of `portbench/queries/
clickbench/`, in PyTorch: one function per query, over the `hits` columns
that the benchmark's generator made (never the port's tables).

Integers are summed in int64 and averages divided in float64, on whatever
device the columns lie on (on the card after the window, where 10^8 rows
take seconds). String predicates and string functions (LIKE, length,
regexp_replace) are evaluated once per dictionary entry in Python and
gathered by code; the dictionaries are sorted, so code order is string
order (MIN, ORDER BY). Each function returns the expected-result record of
`harness/compare.py`, with the query's ORDER BY, LIMIT and OFFSET. Imports
nothing of the port.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from reference._rows import count, distinct_count, group, lowest, result, \
    total

DAY_2013_07_01 = 15887
DAY_2013_07_02 = 15888
DAY_2013_07_31 = 15917



class Hits:
    """The generated `hits` columns (the live rows), read as int64."""

    def __init__(self, tables: dict) -> None:
        t = tables["hits"]
        n = t["rows"]
        #: every column, in the table's order (SELECT *)
        self.columns = {k: v[:n] for k, v in t["columns"].items()}
        self.dicts = t["dicts"]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name].to(torch.int64)

    @property
    def device(self):
        return next(iter(self.columns.values())).device

    def per_entry(self, name: str, fn, dtype=torch.bool) -> torch.Tensor:
        """``fn`` of each dictionary entry of ``name``, gathered per row."""
        lut = torch.as_tensor([fn(s) for s in self.dicts[name].tolist()],
                              dtype=dtype, device=self.device)
        return lut[self[name]]

    def nonempty(self, name: str) -> torch.Tensor:
        return self.per_entry(name, lambda s: s != "")

    def like(self, name: str, part: str) -> torch.Tensor:
        """``name LIKE '%part%'``."""
        return self.per_entry(name, lambda s: part in s)

    def string(self, name: str, codes: torch.Tensor, alias=None):
        """An output column of ``name``'s codes, named ``alias``."""
        return (alias or name, codes, self.dicts[name])


def _scalar(name: str, value, dtype=torch.int64) -> tuple:
    return (name, torch.as_tensor([value], dtype=dtype), None)


def _avg(inv, values, groups):
    return (total(inv, values, groups).to(torch.float64)
            / count(inv, groups).to(torch.float64))


def q0(h):
    return result([_scalar("c", h["CounterID"].numel())])


def q1(h):
    return result([_scalar("c", int((h["AdvEngineID"] != 0).sum()))])


def q2(h):
    n = h["ResolutionWidth"].numel()
    return result([
        _scalar("s", int(h["AdvEngineID"].sum())),
        _scalar("c", n),
        _scalar("a", int(h["ResolutionWidth"].sum()) / n, torch.float64),
    ])


def q3(h):
    u = h["UserID"]
    return result([_scalar("a", int(u.sum()) / u.numel(), torch.float64)])


def q4(h):
    return result([_scalar("u", torch.unique(h["UserID"]).numel())])


def q5(h):
    return result([_scalar("u", torch.unique(h["SearchPhrase"]).numel())])


def q6(h):
    d = h["EventDate"]
    return result([_scalar("mn", int(d.min())), _scalar("mx", int(d.max()))])


def _counts(h, keys: list, names: list, where=None, order_desc=True,
            limit=10, offset=0):
    """SELECT keys..., COUNT(*) AS c ... GROUP BY keys ORDER BY c DESC."""
    cols = [h[k] for k in keys]
    if where is not None:
        cols = [c[where] for c in cols]
    inv, uniq = group(cols)
    g = uniq[0].numel() if uniq else 0
    out = [h.string(k, u) if k in h.dicts else (name, u, None)
           for k, name, u in zip(keys, names, uniq)]
    out.append(("c", count(inv, g), None))
    return result(out, [(len(keys), order_desc)], limit=limit, offset=offset)


def q7(h):
    return _counts(h, ["AdvEngineID"], ["AdvEngineID"],
                   h["AdvEngineID"] != 0, limit=None)


def _distinct_users(h, keys: list, where=None, name="u"):
    cols = [h[k] for k in keys]
    users = h["UserID"]
    if where is not None:
        cols, users = [c[where] for c in cols], users[where]
    inv, uniq = group(cols)
    g = uniq[0].numel()
    out = [h.string(k, u) if k in h.dicts else (k, u, None)
           for k, u in zip(keys, uniq)]
    out.append((name, distinct_count(inv, users, g), None))
    return result(out, [(len(keys), True)], limit=10)


def q8(h):
    return _distinct_users(h, ["RegionID"])


def q9(h):
    inv, (region,) = group([h["RegionID"]])
    g = region.numel()
    return result([
        ("RegionID", region, None),
        ("s", total(inv, h["AdvEngineID"], g), None),
        ("c", count(inv, g), None),
        ("a", _avg(inv, h["ResolutionWidth"], g), None),
        ("u", distinct_count(inv, h["UserID"], g), None),
    ], [(2, True)], limit=10)


def q10(h):
    return _distinct_users(h, ["MobilePhoneModel"],
                           h.nonempty("MobilePhoneModel"))


def q11(h):
    return _distinct_users(h, ["MobilePhone", "MobilePhoneModel"],
                           h.nonempty("MobilePhoneModel"))


def q12(h):
    return _counts(h, ["SearchPhrase"], ["SearchPhrase"],
                   h.nonempty("SearchPhrase"))


def q13(h):
    return _distinct_users(h, ["SearchPhrase"], h.nonempty("SearchPhrase"),
                           name="c")


def q14(h):
    return _counts(h, ["SearchEngineID", "SearchPhrase"],
                   ["SearchEngineID", "SearchPhrase"],
                   h.nonempty("SearchPhrase"))


def q15(h):
    return _counts(h, ["UserID"], ["UserID"])


def q16(h):
    return _counts(h, ["UserID", "SearchPhrase"], ["UserID", "SearchPhrase"])


def q17(h):
    inv, (user, phrase) = group([h["UserID"], h["SearchPhrase"]])
    g = user.numel()
    return result([("UserID", user, None), h.string("SearchPhrase", phrase),
                   ("c", count(inv, g), None)], limit=10)


def q18(h):
    minute = torch.div(h["EventTime"], 60, rounding_mode="floor") % 60
    inv, (user, m, phrase) = group([h["UserID"], minute, h["SearchPhrase"]])
    g = user.numel()
    return result([("UserID", user, None), ("m", m, None),
                   h.string("SearchPhrase", phrase),
                   ("c", count(inv, g), None)], [(3, True)], limit=10)


def q19(h):
    u = h["UserID"]
    return result([("UserID", u[u == 12345], None)])


def q20(h):
    return result([_scalar("c", int(h.like("URL", "google").sum()))])


def q21(h):
    where = h.like("URL", "google") & h.nonempty("SearchPhrase")
    inv, (phrase,) = group([h["SearchPhrase"][where]])
    g = phrase.numel()
    return result([h.string("SearchPhrase", phrase),
                   h.string("URL", lowest(inv, h["URL"][where], g), "mn"),
                   ("c", count(inv, g), None)], [(2, True)], limit=10)


def q22(h):
    where = (h.like("Title", "Google") & ~h.like("URL", ".google.")
             & h.nonempty("SearchPhrase"))
    inv, (phrase,) = group([h["SearchPhrase"][where]])
    g = phrase.numel()
    return result([
        h.string("SearchPhrase", phrase),
        h.string("URL", lowest(inv, h["URL"][where], g), "mn"),
        h.string("Title", lowest(inv, h["Title"][where], g), "mt"),
        ("c", count(inv, g), None),
        ("u", distinct_count(inv, h["UserID"][where], g), None),
    ], [(3, True)], limit=10)


def _rows(h, where, names: list):
    return [h.string(k, h[k][where]) if k in h.dicts
            else (k, h[k][where], None) for k in names]


def q23(h):
    where = h.like("URL", "google")
    names = list(h.columns)
    cols = _rows(h, where, names)
    return result(cols, [(names.index("EventTime"), False)], limit=10)


def q24(h):
    where = h.nonempty("SearchPhrase")
    cols = _rows(h, where, ["SearchPhrase"])
    cols.append(("#EventTime", h["EventTime"][where], None))
    return result(cols, [(1, False)], limit=10)


def q25(h):
    where = h.nonempty("SearchPhrase")
    return result(_rows(h, where, ["SearchPhrase"]), [(0, False)], limit=10)


def q26(h):
    where = h.nonempty("SearchPhrase")
    cols = _rows(h, where, ["SearchPhrase"])
    cols.append(("#EventTime", h["EventTime"][where], None))
    return result(cols, [(1, False), (0, False)], limit=10)


def q27(h):
    where = h.nonempty("URL")
    length = h.per_entry("URL", len, torch.int64)[where]
    inv, (counter,) = group([h["CounterID"][where]])
    g = counter.numel()
    c = count(inv, g)
    keep = c > 100
    return result([("CounterID", counter[keep], None),
                   ("l", _avg(inv, length, g)[keep], None),
                   ("c", c[keep], None)], [(1, True)], limit=25)


_REFERER_HOST = re.compile(r"^https?://([^/]+)/.*$")


def q28(h):
    refs = h.dicts["Referer"].tolist()
    keys = [_REFERER_HOST.sub(r"\1", s) for s in refs]
    kdict = np.unique(np.asarray(keys, dtype=str))
    kcode = np.searchsorted(kdict, np.asarray(keys, dtype=str))
    where = h.nonempty("Referer")
    ref = h["Referer"][where]
    k = torch.as_tensor(kcode, dtype=torch.int64, device=h.device)[ref]
    length = h.per_entry("Referer", len, torch.int64)[where]
    inv, (key,) = group([k])
    g = key.numel()
    c = count(inv, g)
    keep = c > 10
    return result([("k", key[keep], kdict),
                   ("l", _avg(inv, length, g)[keep], None),
                   ("c", c[keep], None),
                   h.string("Referer", lowest(inv, ref, g)[keep], "mn")],
                  [(1, True)], limit=25)


def q29(h):
    w = h["ResolutionWidth"]
    s, n = int(w.sum()), w.numel()
    return result([_scalar(f"s{i}", s + i * n) for i in range(5)])


def _hits_by(h, keys: list, where=None):
    cols = [h[k] for k in keys] + [h["IsRefresh"], h["ResolutionWidth"]]
    if where is not None:
        cols = [c[where] for c in cols]
    inv, uniq = group(cols[:len(keys)])
    g = uniq[0].numel()
    return result([(k, u, None) for k, u in zip(keys, uniq)] + [
        ("c", count(inv, g), None),
        ("r", total(inv, cols[-2], g), None),
        ("a", _avg(inv, cols[-1], g), None),
    ], [(len(keys), True)], limit=10)


def q30(h):
    return _hits_by(h, ["SearchEngineID", "ClientIP"],
                    h.nonempty("SearchPhrase"))


def q31(h):
    return _hits_by(h, ["WatchID", "ClientIP"], h.nonempty("SearchPhrase"))


def q32(h):
    return _hits_by(h, ["WatchID", "ClientIP"])


def q33(h):
    return _counts(h, ["URL"], ["URL"])


def q34(h):
    return _counts(h, ["URL", "CounterID"], ["URL", "CounterID"])


def q35(h):
    inv, (ip,) = group([h["ClientIP"]])
    g = ip.numel()
    return result([("ClientIP", ip, None), ("c1", ip - 1, None),
                   ("c2", ip - 2, None), ("c3", ip - 3, None),
                   ("c", count(inv, g), None)], [(4, True)], limit=10)


def _counter62(h, last_day: int):
    d = h["EventDate"]
    return ((h["CounterID"] == 62) & (d >= DAY_2013_07_01) & (d <= last_day)
            & (h["DontCountHits"] == 0) & (h["IsRefresh"] == 0))


def q36(h):
    where = _counter62(h, DAY_2013_07_31) & h.nonempty("URL")
    return _counts(h, ["URL"], ["URL"], where)


def q37(h):
    where = _counter62(h, DAY_2013_07_31) & h.nonempty("Title")
    return _counts(h, ["Title"], ["Title"], where)


def q38(h):
    where = ((h["IsRefresh"] == 0) & (h["IsLink"] != 0)
             & (h["IsDownload"] == 0))
    return _counts(h, ["URL"], ["URL"], where, offset=100)


def q39(h):
    keys = ["TraficSourceID", "SearchEngineID", "AdvEngineID"]
    return _counts(h, keys, keys, h["IsRefresh"] == 0)


def q40(h):
    t = h["TraficSourceID"]
    where = ((h["IsRefresh"] == 0) & ((t == -1) | (t == 6))
             & (h["RefererHash"] == 123456))
    return _counts(h, ["URLHash", "EventDate"], ["URLHash", "EventDate"],
                   where)


def q41(h):
    where = ((h["IsRefresh"] == 0) & (h["DontCountHits"] == 0)
             & (h["URLHash"] == 123456))
    keys = ["WindowClientWidth", "WindowClientHeight"]
    return _counts(h, keys, keys, where)


def q42(h):
    where = _counter62(h, DAY_2013_07_02)
    t = h["EventTime"][where]
    inv, (m,) = group([t - t % 60])
    g = m.numel()
    return result([("m", m, None), ("c", count(inv, g), None)],
                  [(0, False)], limit=10)


QUERIES = {f"q{i}": globals()[f"q{i}"] for i in range(43)}


def prepare(tables: dict, ctx: dict | None = None) -> Hits:
    """The columns lie on their device already; every answer is exact, so
    ``ctx`` (the float tolerance, the device) changes nothing here."""
    return Hits(tables)
