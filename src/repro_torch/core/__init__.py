"""The staged query compiler, on torch (see the `repro` package's `core`
for the reference):

  expr.py / ir.py     — expression + plan IR (incl. Param query parameters)
  passes/             — the optimization-pass library (paper §3)
  analysis/           — schema/property inference and the pass verifier
  operators/          — physical operators: stage(node, ctx) -> Frame
  backend.py          — the torch ops whose semantics the operators rely on
  compile.py          — staging: one resident program per query
"""
from repro_torch.core.compile import CompiledQuery
from repro_torch.core.passes.pipeline import (LADDER, Settings, degrade,
                                              optimize, preset)

__all__ = ["CompiledQuery", "Settings", "optimize", "preset", "degrade",
           "LADDER"]
