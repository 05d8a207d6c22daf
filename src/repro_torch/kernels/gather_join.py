"""Foreign-key gather (the paper's partitioned PK/FK join probe, `MR[fk]`):
the CUDA kernel and, beside it, its plain torch version.

Contract (the reference's `gather_join`): `out[i, :] = table[fk[i], :]`
for an int32 key vector `fk (n,)` and a float32 table `(K, C)`, and zeros
where `fk[i]` is outside `[0, K)`; the output is `(n, C)` float32,
row-major.  Every output is an exact copy of a table entry or zero: the
reference's TPU kernel computes the gather as a one-hot product, which
turns a NaN or infinity anywhere in the table into NaN in every row; the
port follows the reference's oracle (`ref.gather_join_ref`) instead.

Which version runs is decided by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (see
`csrc/gather_join.cu` for its design) or raises.  `launches` counts
kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = {"gather_join": 0}


def gather_join_plain(fk, table):
    k = table.shape[0]
    ok = (fk >= 0) & (fk < k)
    out = table[fk.clamp(0, max(k - 1, 0)).long()]
    return torch.where(ok[:, None], out, 0.0)


_STATIC: list = []


def _lib():
    if not _STATIC:
        lib = build.load("gather_join", build.static_source("gather_join"))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_gather_join.argtypes = [vp, vp, ll, i, i, vp, vp]
        lib.repro_gather_join.restype = ctypes.c_int
        _STATIC.append(lib)
    return _STATIC[0]


def staged_in_shared_memory(table) -> bool:
    """Whether the kernel stages `table` in shared memory: never, it reads
    every table through the read-only cache."""
    return False


def _gather_join_cuda(fk, table):
    build.check_cuda_1d("fk", fk, torch.int32)
    if table.device != fk.device:
        raise ValueError("fk and table lie on different devices")
    if table.dtype != torch.float32 or table.ndim != 2 \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous (K, C) float32 tensor")
    k, c = table.shape
    if not 0 < k < 2**31 or not 0 <= c < 2**31:
        raise ValueError(f"table shape {tuple(table.shape)} out of range")
    n = fk.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=fk.device)
    if n and c:
        build.check(_lib().repro_gather_join(
            build.ptr(fk), build.ptr(table), n, k, c, build.ptr(out),
            build.stream_ptr(fk)), "gather_join")
        launches["gather_join"] += 1
    return out


def gather_join(fk, table):
    """`(n, C)` float32: `table[fk[i]]`, zeros where fk is out of range."""
    if fk.device.type == "cpu":
        return gather_join_plain(fk, table)
    return _gather_join_cuda(fk, table)
