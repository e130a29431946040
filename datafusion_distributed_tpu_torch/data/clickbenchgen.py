"""Synthetic ClickBench `hits` table on numpy alone (port of the reference
`data/clickbenchgen.py`).

The 25 columns the 43 queries of `benchmarks/queries/clickbench/` touch,
with the reference generator's domains. It makes exactly the reference's
RNG calls in the same order, so the same seed gives the same values; like
`data/tpchgen.py` it returns host columns that `Table.from_numpy` uploads,
encoded as the reference's Arrow path encodes them (each dictionary the
sorted set of the column's values, all-true validity).

String columns are built as dictionary codes, never as per-row Python
strings: URL is one of 10 hosts x 5,000 paths (at most 50,000 distinct
values), so the published 99,997,497 rows generate in seconds. `URLHash` is
Python's `hash()` of the URL string, which is salted per process; it is
computed once per distinct URL and gathered, so it equals the reference's
within one process.
"""

from __future__ import annotations

import numpy as np

from datafusion_distributed_tpu_torch.data.tpchgen import (
    HostTable,
    _TableBuilder,
)
from datafusion_distributed_tpu_torch.ops.table import Dictionary
from datafusion_distributed_tpu_torch.schema import DataType, Field

_EPOCH_2013_07_01 = 15887  # days since epoch
_SECS_2013_07_01 = _EPOCH_2013_07_01 * 86400
_DAYS = 31
_PATHS = 5000

_PHRASES = ["", "", "", "", "", "", "", "",  # ~72% empty like the real data
            "car", "cheap flights", "weather moscow", "news today",
            "how to cook rice", "google maps", "python tutorial",
            "hotel deals", "football scores", "movie times",
            "best laptop 2013", "train tickets"]
_PHONE_MODELS = ["", "", "", "", "", "iPhone 5", "Galaxy S4", "Lumia 920",
                 "Xperia Z", "Nexus 4"]
_URL_HOSTS = ["http://example.com", "http://google.ru/search",
              "http://news.site", "http://shop.online", "http://maps.app",
              "http://video.portal", "http://maps.google.com/dir",
              "http://forum.board", "http://mail.box", "http://blog.spot"]
_TITLES = ["Home", "Search results - Google", "News", "Shop",
           "Google Maps", "Video", "Forum", "Mail", "Blog", "Weather", ""]
_REFERERS = ["", "", "http://google.ru/", "http://direct.link/",
             "http://social.net/", "http://mail.box/"]


def _add_urls(b: _TableBuilder, hosts, paths) -> np.ndarray:
    """Add URL as codes into the sorted set of the URLs present; -> the
    URLHash column, from one `hash()` per distinct URL."""
    combo = hosts.astype(np.int64) * _PATHS + paths
    present = np.flatnonzero(
        np.bincount(combo, minlength=len(_URL_HOSTS) * _PATHS))
    strs = np.asarray(
        [f"{_URL_HOSTS[c // _PATHS]}/{c % _PATHS}" for c in present])
    order = np.argsort(strs, kind="stable")
    lut = np.zeros(len(_URL_HOSTS) * _PATHS, dtype=np.int32)
    lut[present[order]] = np.arange(len(present), dtype=np.int32)
    hashes = np.zeros(len(_URL_HOSTS) * _PATHS, dtype=np.int64)
    hashes[present] = [hash(s) & 0x7FFFFFFF for s in strs]
    b.fields.append(Field("URL", DataType.STRING, True))
    b.data["URL"] = lut[combo]
    b.dicts["URL"] = Dictionary(strs[order].astype(object))
    return hashes[combo]


def gen_clickbench(rows: int = 100_000, seed: int = 0) -> HostTable:
    """Generate the `hits` table as host columns."""
    rng = np.random.default_rng(seed)
    n = rows

    event_day = rng.integers(0, _DAYS, n)
    event_date = (_EPOCH_2013_07_01 + event_day).astype(np.int32)
    event_time = (
        _SECS_2013_07_01 + event_day * 86400 + rng.integers(0, 86400, n)
    ).astype(np.int64)
    del event_day
    hosts = rng.integers(0, len(_URL_HOSTS), n)
    paths = rng.integers(0, _PATHS, n)

    b = _TableBuilder()
    b.add("WatchID", DataType.INT64, rng.integers(1, 2**31 - 1, n))
    b.add("UserID", DataType.INT64, rng.integers(1, 200_000, n))
    b.add("CounterID", DataType.INT32,
          rng.integers(1, 100, n).astype(np.int32))
    b.add("ClientIP", DataType.INT32,
          rng.integers(0, 2**31 - 1, n).astype(np.int32))
    b.add("RegionID", DataType.INT32, rng.integers(1, 300, n).astype(np.int32))
    b.add("EventDate", DataType.DATE32, event_date)
    b.add("EventTime", DataType.INT64, event_time)
    b.add_choice("Title", _TITLES, rng.integers(0, len(_TITLES), n))
    url_hash = _add_urls(b, hosts, paths)
    del hosts, paths
    b.add_choice("Referer", _REFERERS, rng.integers(0, len(_REFERERS), n))
    b.add("URLHash", DataType.INT64, url_hash)
    b.add("RefererHash", DataType.INT64, rng.integers(0, 2**31 - 1, n))
    b.add_choice("SearchPhrase", _PHRASES, rng.integers(0, len(_PHRASES), n))

    def sparse(p_zero: float, hi: int):
        zero = rng.random(n) < p_zero
        return np.where(zero, 0, rng.integers(1, hi, n)).astype(np.int16)

    def flag(p: float):
        return (rng.random(n) < p).astype(np.int16)

    b.add("SearchEngineID", DataType.INT32, sparse(0.8, 6))
    b.add("AdvEngineID", DataType.INT32, sparse(0.95, 20))
    b.add("MobilePhone", DataType.INT32, sparse(0.85, 8))
    b.add_choice("MobilePhoneModel", _PHONE_MODELS,
                 rng.integers(0, len(_PHONE_MODELS), n))
    b.add("ResolutionWidth", DataType.INT32, rng.choice(
        [0, 1024, 1280, 1366, 1440, 1600, 1920, 2560],
        n, p=[0.05, 0.1, 0.2, 0.25, 0.1, 0.1, 0.15, 0.05]
    ).astype(np.int16))
    b.add("WindowClientWidth", DataType.INT32,
          rng.integers(0, 2000, n).astype(np.int16))
    b.add("WindowClientHeight", DataType.INT32,
          rng.integers(0, 1200, n).astype(np.int16))
    b.add("TraficSourceID", DataType.INT32,
          rng.integers(-1, 10, n).astype(np.int8))
    b.add("IsRefresh", DataType.INT32, flag(0.1))
    b.add("IsLink", DataType.INT32, flag(0.2))
    b.add("IsDownload", DataType.INT32, flag(0.05))
    b.add("DontCountHits", DataType.INT32, flag(0.05))
    return b.build()


def register_clickbench(ctx, rows: int = 100_000, seed: int = 0) -> HostTable:
    """Generate `hits` and register it in a SessionContext (on its device);
    returns the HostTable."""
    host = gen_clickbench(rows=rows, seed=seed)
    ctx.register_table("hits", host.to_table(ctx.device))
    return host
