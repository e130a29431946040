"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers: a build takes seconds), named by the
hash of its source so that an edited source rebuilds, and loaded with
``ctypes``. The build directory is ``_build/`` inside the package, which
``.gitignore`` lists. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: dict = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its hashed library exists.
    -> (library path, the compiler's output: ``-Xptxas -v`` register and
    shared-memory report)."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(tmp), str(CSRC / source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    if source not in _LIBS:
        # lock-while-building witness (runtime/lockcheck.py, opt-in via
        # DFTPU_LOCK_CHECK=1): an engine lock held across an nvcc run
        # stalls every contender for seconds
        from datafusion_distributed_tpu_torch.runtime import lockcheck

        lockcheck.note_blocking("kernel_build")
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path, _ = build(source)
            lib = ctypes.CDLL(str(path))
            _LIBS[source] = lib
        return lib
