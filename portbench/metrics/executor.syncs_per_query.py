"""executor.syncs_per_query: the CUDA runtime's stream and device
synchronizations and async copies the host issued per query (each copy to
the host waits for the stream), counted from the profiler's runtime calls
as `chip_smoke.py` counts them."""

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync")


def read(rec: dict):
    qs = rec["queries"]
    if not qs:
        return None
    calls = sum(rec["runtime"].get(name, 0) for name in SYNC_CALLS)
    return calls / len(qs)
