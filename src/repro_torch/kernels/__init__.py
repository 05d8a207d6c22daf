"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version: stream compaction (`compact.py`) and masked grouped
aggregation (`filter_agg.py`), with the kernel source generated from
plan expressions by `codegen.py` where the predicate runs in-kernel.
`ops.py` is the engine's entry point."""
