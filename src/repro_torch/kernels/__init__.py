"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version: stream compaction (`compact.py`), masked grouped aggregation
(`filter_agg.py`), the foreign-key gather (`gather_join.py`) and masked
top-k (`topk.py`), with the kernel source generated from plan
expressions by `codegen.py` where the predicate runs in-kernel.

The package exports the reference's kernel library surface (`ops.py`);
`ref` holds the plain versions under the reference oracles' names.  The
exported functions shadow the modules of the same names (`compact`,
`filter_agg`, `gather_join`): import a module's own names from it
(`from repro_torch.kernels.compact import launches`)."""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (compact, compact_pred, compact_translate,
                                     filter_agg, gather_join, masked_topk,
                                     selective_filter_agg)

__all__ = ["ops", "ref", "filter_agg", "gather_join", "masked_topk",
           "compact", "compact_translate", "compact_pred",
           "selective_filter_agg"]
