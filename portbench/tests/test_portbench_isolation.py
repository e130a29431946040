"""The plain reference and the generators import nothing of the port, and
nothing of JAX: compared by whole top-level module names, since the port's
name begins with the JAX package's."""

import subprocess
import sys

from _run import HERE

BLOCKED = ["jax", "jaxlib", "flax", "datafusion_distributed_tpu",
           "datafusion_distributed_tpu_torch"]


def test_reference_and_generators_stand_alone():
    code = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # importing any of them now raises
sys.path[:0] = [{str(HERE)!r}]
from harness import cells
for kind, name in [("reference", "tpch"), ("reference", "clickbench"),
                   ("generators", "tpch"), ("generators", "clickbench_hits")]:
    cells.module(kind, name)
from harness import compare, trace, roofline  # noqa: F401
tops = {{m.split(".")[0] for m, v in sys.modules.items() if v is not None}}
print(sorted(tops & set({BLOCKED!r})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names():
    sys.path.insert(0, str(HERE))
    import run

    saved = dict(sys.modules)
    before = run.forbidden_modules()
    try:
        sys.modules["datafusion_distributed_tpu_torch_x"] = object()
        sys.modules["datafusion_distributed_tpu_torch.ops"] = object()
        sys.modules["jaxtyping"] = object()
        assert run.forbidden_modules() == before
        sys.modules["jax.numpy"] = object()
        assert "jax" in run.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
