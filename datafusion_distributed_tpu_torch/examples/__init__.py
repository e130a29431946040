"""The JAX package's runnable examples (`examples/`), ported: one module
each, of the same name, each with ``run(device=None, n=...) -> dict`` (what
the example observes, as ``{"frames": ..., "facts": ..., "observed": ...}``:
see `_common`) and a ``main()`` that prints what the JAX package's example
prints:

    python -m datafusion_distributed_tpu_torch.examples.<name> [--device cpu]

Like the port's other entry points they run on the card unless the caller
asks for the CPU; without CUDA and without ``device="cpu"`` they raise.
README.md beside this file maps each to the reference crate's example.
"""

EXAMPLES = ("in_memory_cluster", "custom_execution_plan",
            "custom_partial_reduction_tree", "custom_worker_routing",
            "versioned_rolling_upgrade", "work_unit_feed",
            "localhost_cluster", "console_monitor", "mesh_workers_cluster",
            "mesh_spmd_query")
