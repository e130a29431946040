"""ClickBench's `hits` table, drawn on the device: its values from a fixed
``data_seed``, its row order from the run's seed.

All 105 columns of ClickBench's `create.sql`, in its order (`SCHEMA`). The
25 that the 43 queries read keep the domains of the port's
`data/clickbenchgen.py` (of which this is a frozen copy); the other 80 get
plain domains of their type (`_OTHER`), since no query reads them but
`SELECT *`, and they hold the table's width on the card. Every column is an
independent uniform or categorical draw from one `torch.Generator` on the
given device, in a few large calls, so 10^7-10^8 rows take seconds on the
card and no host-to-device copy. String columns are int32 codes into sorted
host-side dictionaries: URL is one of 10 hosts x 5,000 paths, coded into the
sorted dictionary of those 50,000 strings. The values, and so the number of
distinct keys, are the generator's, not those of the real `hits.parquet`.

Two departures from the port's generator, both about determinism: the
values come from torch's generator, not numpy's, and `URLHash` is a stable
hash of the URL string (the port's is Python's `hash()`, which is salted per
process, so its values changed with every process). Every dictionary holds
all the values its column can take, present or not.

The values come from ``data_seed`` alone, so every run holds the same
multiset of rows, as every run of ClickBench reads the same `hits.parquet`;
the run's ``seed`` draws a permutation of the rows. Values drawn from the
run's seed changed the work: q30's and q31's segmented float64 sums took
2.2 ms more on some seeds' values than on others', reproducibly per seed,
and no such step shows between orders of one set of values.

`generate(rows, seed, device, capacity, data_seed)` returns ``{"hits":
{"columns": {name: tensor}, "types": {name: type}, "dicts": {name: sorted
str array}}}``.
Each column is a tensor of ``capacity`` (default ``rows``) entries whose
first ``rows`` are the table and whose tail is zero: int64 for the types
``int64`` (BIGINT, and TIMESTAMP as seconds since 1970), int32 for
``int32`` (SMALLINT, INTEGER), ``date32`` (days since 1970) and ``string``
(codes; TEXT, VARCHAR, CHAR). The same seeds on the same device give the
same table. Nothing here imports the port.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_EPOCH_2013_07_01 = 15887  # days since 1970-01-01
_SECS_2013_07_01 = _EPOCH_2013_07_01 * 86400
_DAYS = 31
_PATHS = 5000

_PHRASES = ["", "", "", "", "", "", "", "",  # ~72% empty, as in the real data
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
_RESOLUTIONS = [0, 1024, 1280, 1366, 1440, 1600, 1920, 2560]
_RESOLUTION_P = [0.05, 0.1, 0.2, 0.25, 0.1, 0.1, 0.15, 0.05]

#: ClickBench's `hits` (create.sql): every column in its order, with the
#: generator's kind for it
SCHEMA = [
    ("WatchID", "int64"), ("JavaEnable", "int32"), ("Title", "string"),
    ("GoodEvent", "int32"), ("EventTime", "int64"), ("EventDate", "date32"),
    ("CounterID", "int32"), ("ClientIP", "int32"), ("RegionID", "int32"),
    ("UserID", "int64"), ("CounterClass", "int32"), ("OS", "int32"),
    ("UserAgent", "int32"), ("URL", "string"), ("Referer", "string"),
    ("IsRefresh", "int32"), ("RefererCategoryID", "int32"),
    ("RefererRegionID", "int32"), ("URLCategoryID", "int32"),
    ("URLRegionID", "int32"), ("ResolutionWidth", "int32"),
    ("ResolutionHeight", "int32"), ("ResolutionDepth", "int32"),
    ("FlashMajor", "int32"), ("FlashMinor", "int32"),
    ("FlashMinor2", "string"), ("NetMajor", "int32"), ("NetMinor", "int32"),
    ("UserAgentMajor", "int32"), ("UserAgentMinor", "string"),
    ("CookieEnable", "int32"), ("JavascriptEnable", "int32"),
    ("IsMobile", "int32"), ("MobilePhone", "int32"),
    ("MobilePhoneModel", "string"), ("Params", "string"),
    ("IPNetworkID", "int32"), ("TraficSourceID", "int32"),
    ("SearchEngineID", "int32"), ("SearchPhrase", "string"),
    ("AdvEngineID", "int32"), ("IsArtifical", "int32"),
    ("WindowClientWidth", "int32"), ("WindowClientHeight", "int32"),
    ("ClientTimeZone", "int32"), ("ClientEventTime", "int64"),
    ("SilverlightVersion1", "int32"), ("SilverlightVersion2", "int32"),
    ("SilverlightVersion3", "int32"), ("SilverlightVersion4", "int32"),
    ("PageCharset", "string"), ("CodeVersion", "int32"), ("IsLink", "int32"),
    ("IsDownload", "int32"), ("IsNotBounce", "int32"), ("FUniqID", "int64"),
    ("OriginalURL", "string"), ("HID", "int32"), ("IsOldCounter", "int32"),
    ("IsEvent", "int32"), ("IsParameter", "int32"),
    ("DontCountHits", "int32"), ("WithHash", "int32"),
    ("HitColor", "string"), ("LocalEventTime", "int64"), ("Age", "int32"),
    ("Sex", "int32"), ("Income", "int32"), ("Interests", "int32"),
    ("Robotness", "int32"), ("RemoteIP", "int32"), ("WindowName", "int32"),
    ("OpenerName", "int32"), ("HistoryLength", "int32"),
    ("BrowserLanguage", "string"), ("BrowserCountry", "string"),
    ("SocialNetwork", "string"), ("SocialAction", "string"),
    ("HTTPError", "int32"), ("SendTiming", "int32"), ("DNSTiming", "int32"),
    ("ConnectTiming", "int32"), ("ResponseStartTiming", "int32"),
    ("ResponseEndTiming", "int32"), ("FetchTiming", "int32"),
    ("SocialSourceNetworkID", "int32"), ("SocialSourcePage", "string"),
    ("ParamPrice", "int64"), ("ParamOrderID", "string"),
    ("ParamCurrency", "string"), ("ParamCurrencyID", "int32"),
    ("OpenstatServiceName", "string"), ("OpenstatCampaignID", "string"),
    ("OpenstatAdID", "string"), ("OpenstatSourceID", "string"),
    ("UTMSource", "string"), ("UTMMedium", "string"),
    ("UTMCampaign", "string"), ("UTMContent", "string"),
    ("UTMTerm", "string"), ("FromTag", "string"), ("HasGCLID", "int32"),
    ("RefererHash", "int64"), ("URLHash", "int64"), ("CLID", "int32"),
]

#: the 80 columns no query reads but `SELECT *`: an integer column is
#: uniform in [lo, hi), a string column a uniform choice (repeats weigh
#: more); a timestamp is drawn as EventTime is
_OTHER = {
    "JavaEnable": (0, 2), "GoodEvent": (0, 2), "CounterClass": (0, 5),
    "OS": (0, 100), "UserAgent": (0, 60), "RefererCategoryID": (0, 20),
    "RefererRegionID": (0, 300), "URLCategoryID": (0, 20),
    "URLRegionID": (0, 300), "ResolutionHeight": (0, 1600),
    "ResolutionDepth": (0, 33), "FlashMajor": (0, 12), "FlashMinor": (0, 10),
    "FlashMinor2": ["", "", "0", "1", "2", "5"], "NetMajor": (0, 5),
    "NetMinor": (0, 10), "UserAgentMajor": (0, 40),
    "UserAgentMinor": ["", "0", "1", "5", "10"], "CookieEnable": (0, 2),
    "JavascriptEnable": (0, 2), "IsMobile": (0, 2), "Params": ["", "", "a=1"],
    "IPNetworkID": (0, 2**20), "IsArtifical": (0, 2),
    "ClientTimeZone": (-12, 13), "ClientEventTime": "time",
    "SilverlightVersion1": (0, 6), "SilverlightVersion2": (0, 10),
    "SilverlightVersion3": (0, 100_000), "SilverlightVersion4": (0, 100),
    "PageCharset": ["", "utf-8", "windows-1251"], "CodeVersion": (0, 1000),
    "IsNotBounce": (0, 2), "FUniqID": (0, 2**31 - 1),
    "OriginalURL": ["", "", "", "http://example.com/"], "HID": (0, 2**31 - 1),
    "IsOldCounter": (0, 2), "IsEvent": (0, 2), "IsParameter": (0, 2),
    "WithHash": (0, 2), "HitColor": ["5", "D", "E", "F"],
    "LocalEventTime": "time", "Age": (0, 100), "Sex": (0, 3),
    "Income": (0, 5), "Interests": (0, 1000), "Robotness": (0, 2),
    "RemoteIP": (0, 2**31 - 1), "WindowName": (-1, 1000),
    "OpenerName": (-1, 1000), "HistoryLength": (0, 50),
    "BrowserLanguage": ["", "ru", "en", "uk", "de"],
    "BrowserCountry": ["", "ru", "ua", "by", "kz", "us"],
    "SocialNetwork": ["", "", "", "vk", "fb"], "SocialAction": ["", "like"],
    "HTTPError": (0, 600), "SendTiming": (0, 10_000),
    "DNSTiming": (0, 10_000), "ConnectTiming": (0, 10_000),
    "ResponseStartTiming": (0, 10_000), "ResponseEndTiming": (0, 10_000),
    "FetchTiming": (0, 10_000), "SocialSourceNetworkID": (0, 10),
    "SocialSourcePage": ["", "", "http://social.net/page"],
    "ParamPrice": (0, 100_000), "ParamOrderID": ["", "", "o1", "o2"],
    "ParamCurrency": ["", "RUB", "USD", "EUR"], "ParamCurrencyID": (0, 4),
    "OpenstatServiceName": ["", "", "direct"],
    "OpenstatCampaignID": ["", "", "c1"], "OpenstatAdID": ["", "", "a1"],
    "OpenstatSourceID": ["", "", "s1"], "UTMSource": ["", "yandex", "google"],
    "UTMMedium": ["", "cpc"], "UTMCampaign": ["", "", "spring"],
    "UTMContent": ["", "", "banner"], "UTMTerm": ["", "", "term"],
    "FromTag": ["", "", "direct"], "HasGCLID": (0, 2), "CLID": (0, 1000),
}


def stable_hash(s: str) -> int:
    """A 31-bit hash of a string that is the same in every process."""
    digest = hashlib.blake2b(s.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & 0x7FFFFFFF


def url_strings() -> np.ndarray:
    """Every URL the generator can draw, indexed by host * 5,000 + path."""
    return np.array([f"{h}/{p}" for h in _URL_HOSTS for p in range(_PATHS)])


class _Builder:
    def __init__(self, rows: int, capacity: int, gen, device) -> None:
        self.rows, self.capacity = rows, capacity
        self.gen, self.device = gen, device
        self.columns: dict = {}
        self.types: dict = {}
        self.dicts: dict = {}

    def _put(self, name: str, kind: str, values: torch.Tensor) -> None:
        dtype = torch.int64 if kind == "int64" else torch.int32
        buf = torch.zeros(self.capacity, dtype=dtype, device=self.device)
        buf[:self.rows] = values
        self.columns[name] = buf
        self.types[name] = kind

    def ints(self, lo: int, hi: int) -> torch.Tensor:
        """Uniform integers in [lo, hi)."""
        return torch.randint(lo, hi, (self.rows,), generator=self.gen,
                             device=self.device, dtype=torch.int64)

    def uniform(self) -> torch.Tensor:
        return torch.rand(self.rows, generator=self.gen, device=self.device,
                          dtype=torch.float64)

    def add(self, name: str, kind: str, values: torch.Tensor) -> None:
        self._put(name, kind, values)

    def add_choice(self, name: str, choices) -> None:
        """Strings drawn uniformly from ``choices`` (repeats weigh more)."""
        uniq = np.unique(np.asarray(choices, dtype=str))
        lut = torch.as_tensor(np.searchsorted(uniq, np.asarray(choices)),
                              dtype=torch.int32, device=self.device)
        self._put(name, "string", lut[self.ints(0, len(choices))])
        self.dicts[name] = uniq


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    return gen


def generate(rows: int = 100_000, seed: int = 0, device="cpu",
             capacity: int | None = None, data_seed: int = 0) -> dict:
    """-> {"hits": {"columns", "types", "dicts"}} (see the module doc)."""
    device = torch.device(device)
    b = _Builder(rows, capacity or rows, _generator(data_seed, device),
                 device)

    event_day = b.ints(0, _DAYS)
    b.add("WatchID", "int64", b.ints(1, 2**31 - 1))
    b.add("UserID", "int64", b.ints(1, 200_000))
    b.add("CounterID", "int32", b.ints(1, 100))
    b.add("ClientIP", "int32", b.ints(0, 2**31 - 1))
    b.add("RegionID", "int32", b.ints(1, 300))
    b.add("EventDate", "date32", event_day + _EPOCH_2013_07_01)
    b.add("EventTime", "int64",
          _SECS_2013_07_01 + event_day * 86400 + b.ints(0, 86400))
    del event_day
    b.add_choice("Title", _TITLES)
    urls = url_strings()
    order = np.argsort(urls, kind="stable")
    rank = np.empty(len(urls), dtype=np.int64)
    rank[order] = np.arange(len(urls))
    combo = b.ints(0, len(_URL_HOSTS)) * _PATHS + b.ints(0, _PATHS)
    b.add("URL", "string",
          torch.as_tensor(rank, device=device)[combo])
    b.dicts["URL"] = urls[order]
    b.add_choice("Referer", _REFERERS)
    hashes = torch.as_tensor([stable_hash(u) for u in urls],
                             dtype=torch.int64, device=device)
    b.add("URLHash", "int64", hashes[combo])
    del combo, hashes
    b.add("RefererHash", "int64", b.ints(0, 2**31 - 1))
    b.add_choice("SearchPhrase", _PHRASES)

    def sparse(p_zero: float, hi: int) -> torch.Tensor:
        zero = b.uniform() < p_zero
        return torch.where(zero, 0, b.ints(1, hi))

    def flag(p: float) -> torch.Tensor:
        return (b.uniform() < p).to(torch.int64)

    b.add("SearchEngineID", "int32", sparse(0.8, 6))
    b.add("AdvEngineID", "int32", sparse(0.95, 20))
    b.add("MobilePhone", "int32", sparse(0.85, 8))
    b.add_choice("MobilePhoneModel", _PHONE_MODELS)
    cum = torch.as_tensor(np.cumsum(_RESOLUTION_P)[:-1], dtype=torch.float64,
                          device=device)
    widths = torch.as_tensor(_RESOLUTIONS, dtype=torch.int64, device=device)
    b.add("ResolutionWidth", "int32",
          widths[torch.searchsorted(cum, b.uniform(), right=True)])
    b.add("WindowClientWidth", "int32", b.ints(0, 2000))
    b.add("WindowClientHeight", "int32", b.ints(0, 1200))
    b.add("TraficSourceID", "int32", b.ints(-1, 10))
    b.add("IsRefresh", "int32", flag(0.1))
    b.add("IsLink", "int32", flag(0.2))
    b.add("IsDownload", "int32", flag(0.05))
    b.add("DontCountHits", "int32", flag(0.05))
    kinds = dict(SCHEMA)
    for name, domain in _OTHER.items():
        if isinstance(domain, list):
            b.add_choice(name, domain)
        elif domain == "time":
            b.add(name, "int64", _SECS_2013_07_01 + b.ints(0, _DAYS * 86400))
        else:
            b.add(name, kinds[name], b.ints(*domain))
    assert b.types == {n: kinds[n] for n in b.types} and len(b.types) == 105
    order = torch.randperm(rows, generator=_generator(seed, device),
                           device=device)
    for col in b.columns.values():
        col[:rows] = col[:rows][order]
    return {"hits": {"columns": {n: b.columns[n] for n, _ in SCHEMA},
                     "types": {n: k for n, k in SCHEMA},
                     "dicts": b.dicts, "rows": rows}}
