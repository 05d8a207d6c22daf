"""The plain torch versions under the names of the reference's oracles
(`repro.kernels.ref`).  Each delegates to the plain version that sits
beside its kernel, so the oracle and the kernel's CPU path are one code."""
from __future__ import annotations

import torch

from repro_torch.kernels.compact import compact_plain
from repro_torch.kernels.filter_agg import (filter_agg_plain,
                                            selective_filter_agg_plain)
from repro_torch.kernels.gather_join import gather_join_plain
from repro_torch.kernels.topk import masked_topk_plain


def filter_agg_ref(mask, gidx, vals, n_groups):
    cols = list(vals.to(torch.float32).t())
    return filter_agg_plain(mask, gidx, cols, n_groups)[0]


def gather_join_ref(fk, table):
    return gather_join_plain(fk, table)


def compact_ref(mask, capacity):
    return compact_plain(mask, capacity)


def slot_of_ref(mask):
    return compact_plain(mask, 0, translate=True)[2]


def selective_filter_agg_ref(cols, scalars, pred_fn, vals_fns, gidx_fn,
                             n_vals, n_groups, capacity=0, translate=False):
    if len(vals_fns) != n_vals:
        raise ValueError(f"{len(vals_fns)} value functions for n_vals "
                         f"{n_vals}")
    sums, _counts, total, *rest = selective_filter_agg_plain(
        cols, scalars, pred_fn, list(vals_fns), gidx_fn, n_groups, capacity,
        translate)
    return (sums, total, *rest)


def masked_topk_ref(vals, mask, k):
    return masked_topk_plain(vals, mask, k)
