"""What the benchmark reads from the program besides its results: the
port's kernel launch counters and the names of its CUDA kernels."""

from __future__ import annotations

from pathlib import Path


def launch_shapes() -> tuple:
    """Copies of kernels 1 and 2's launches by shape so far."""
    from datafusion_distributed_tpu_torch.ops import hash_kernels as hk

    return dict(hk.BUILD_SHAPES), dict(hk.PROBE_SHAPES)


def since(before: dict, after: dict) -> dict:
    out = {k: n - before.get(k, 0) for k, n in after.items()}
    return {k: n for k, n in out.items() if n}


def csrc() -> Path:
    import datafusion_distributed_tpu_torch as port

    return Path(port.__file__).resolve().parent / "csrc"
