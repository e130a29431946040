"""The benchmark's own tests (`python -m pytest portbench/tests`): they put
`portbench/` and the checkout's root on the import path and register the
repository's `cuda` marker."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips with a reason where none is "
        "present")
