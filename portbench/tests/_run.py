"""Run one of the benchmark's scripts in a subprocess and read its last
line (shared by the tests)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent


def script(path, *args, timeout=900, env=None, cwd=ROOT):
    """-> (exit code, last stdout line parsed or None, stdout, stderr)."""
    proc = subprocess.run(
        [sys.executable, str(path), *map(str, args)], cwd=cwd,
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, **(env or {})})
    lines = proc.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return proc.returncode, last, proc.stdout, proc.stderr


def rehearse(*args, **kw):
    return script(HERE / "tests" / "rehearse.py", *args, **kw)
