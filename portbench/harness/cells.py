"""Find a cell and everything that belongs to it by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix and each per-layer metric; each lives in a
file of its own under `portbench/`, which these functions find by that
name, so a new cell, mix or metric is a new file and no edit here:

- ``configs/<config>.json``: one deployment (generator, precision mode,
  session options, guarantees);
- ``traffic/<mix>.json``: one traffic mix (queries, entry path, loop);
- ``queries/<suite>/<query>.sql``: the query texts;
- ``generators/<name>.py``, ``reference/<suite>.py``,
  ``entries/<path>.py``, ``metrics/<metric>.py``: modules loaded by file.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent  # the checkout


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str, bench: dict | None = None) -> dict:
    for w in (bench or benchmark())["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def prepared(name: str) -> dict:
    """A cell of BENCHMARK.json, or one that its files make ready but that
    BENCHMARK.json does not list yet: ``<config>.<traffic>`` on one chip,
    for rehearsals and controls (`run.py` runs only listed cells)."""
    try:
        return workload(name)
    except KeyError:
        conf, _, mix = name.partition(".")
        if not ((HERE / "configs" / f"{conf}.json").is_file()
                and (HERE / "traffic" / f"{mix}.json").is_file()):
            raise
        return {"name": name, "config": conf, "traffic": mix, "chips": 1}


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def queries(mix: dict) -> list:
    """[(query name, SQL text)] of a traffic mix, in its listed order."""
    folder = HERE / "queries" / mix["suite"]
    return [(q, (folder / f"{q}.sql").read_text()) for q in mix["queries"]]


def module(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` (a name may hold dots)."""
    key = f"portbench_{kind}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def base(name: str, known) -> str | None:
    """The longest dot-separated head of ``name`` in ``known``. A cell may
    report a quantity under a name of its own (``queries_per_s.power``), and
    a metric is read by the quantity or reader its name begins with."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        head = ".".join(parts[:i])
        if head in known:
            return head
    return None


def reader(name: str):
    """The module that reads the per-layer metric ``name``
    (``metrics/<head>.py``, the longest head of the name that has one)."""
    head = base(name, {p.name[:-3] for p in (HERE / "metrics").glob("*.py")})
    if head is None:
        raise FileNotFoundError(f"no reader under metrics/ for {name!r}")
    return module("metrics", head)


def per_layer(cell: str, bench: dict | None = None) -> list:
    """The per-layer metrics a cell reports, in BENCHMARK.json's order."""
    return [m for m in (bench or benchmark())["per_layer"]
            if cell in m.get("workloads", [cell])]


def end_to_end(cell: str, bench: dict | None = None) -> list:
    return [m for m in (bench or benchmark())["end_to_end"]
            if cell in m.get("workloads", [cell])]
