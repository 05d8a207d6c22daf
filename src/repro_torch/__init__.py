"""PyTorch/CUDA port of the `repro` query engine.

The layout mirrors `repro`: `relational/` (data, schemas, TPC-H queries),
`core/` (expression and plan IR, the optimization passes, the static
analysis, the physical operators and the staging of one program per
query) and `kernels/` (hand-written CUDA kernels for Hopper, each beside
its plain torch version).  The package imports torch and numpy, never JAX.
"""
