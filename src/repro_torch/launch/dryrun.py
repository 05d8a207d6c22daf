"""Multi-pod dry run: trace every (architecture × input shape × mesh)
cell as DTensors over a fake world of 256 or 512 ranks, with nothing
allocated, count what one device does, and emit the roofline terms to
JSON.  The port of `repro/launch/dryrun.py`.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b \\
      --shape train_4k [--multipod] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads XLA's cost and memory analyses.  Here the cell's
`train_step`, `prefill` or `decode_step` runs eagerly on DTensors whose
shards are fake tensors (`FakeTensorMode`): the process is rank 0 of the
production mesh, and a counting dispatch mode sees every operation that
runs on its local shards (`Cost`):

- `flops_per_dev`: `torch.utils.flop_counter`'s formulas over the local
  operations (over the DTensors themselves they would count the global
  product);
- `bytes_per_dev`: the local operand and result bytes of every
  operation, views excepted.  Nothing is fused, so this counts more than
  XLA's "bytes accessed" of a fused program does;
- `collective_bytes_per_dev`, by kind: the operand bytes of each
  functional collective DTensor issues, in `roofline.collective_bytes`'
  convention (an all-gather's operand is the local shard);
- `memory`: the arguments' local bytes from their specs, the outputs',
  and the peak of live local bytes while the step runs.

As in the reference, a model of more than two pattern repeats is traced
at 1 and 2 repeats (`probe_config`) and every count extrapolated
linearly to its depth (an eager trace is linear in depth too; a test
holds the extrapolation to the full count).  The probes take attention's
naive form, whose FLOPs are exact; its S×S bytes are left out of
`bytes_per_dev` and the one-pass flash bytes (`roofline.flash_bytes`)
put in, the reference's blockwise correction; `bytes_per_dev_naive_attn`
keeps them.  The roofline terms use an H100's data-sheet constants, with
NVLink for the collective term (`launch/roofline.py`): a prediction for
a mesh of H100s, not a measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SKIPS, get_config, shapes_for
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_ctx, make_production_mesh, world
from repro_torch.models import attention as A
from repro_torch.models.config import SHAPES
from repro_torch.models.sharding import (Ctx, P, distribute, placements,
                                         spec_leaves)
from repro_torch.models.transformer import LM, decode_step, prefill
from repro_torch.models.tree import leaves
from repro_torch.train.optimizer import AdamConfig, AdamState
from repro_torch.train.train_step import TrainState, train_step

COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_reduce": "all-reduce",
                    "all_to_all_single": "all-to-all",
                    "shard_dim_alltoall": "all-to-all"}
# operations that move no bytes: views, and allocations not yet written
_NO_TRAFFIC = ("empty", "empty_like", "new_empty", "empty_strided",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


class Cost(TorchDispatchMode):
    """Counts the operations on local shards: DTensor operations are
    handed back (NotImplemented) so that DTensor runs them, and the local
    operations it issues come through here."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.attn_bytes = 0          # inside attention's core
        self.coll: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._owners: dict[int, list] = {}
        self.paused = 0
        self.in_attention = 0

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        own = self._owners.get(key)
        if own is None:
            own = self._owners[key] = [st.nbytes(), 0]
            self.live += own[0]
            self.peak = max(self.peak, self.live)
        own[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        own = self._owners.get(key)
        if own is None:
            return
        own[1] -= 1
        if own[1] == 0:
            self.live -= own[0]
            del self._owners[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        pkt = func._overloadpacket
        name = pkt.__name__
        if pkt in flop_registry:
            self.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in COLLECTIVE_KINDS:
            kind = COLLECTIVE_KINDS[name]
            self.coll[kind] = self.coll.get(kind, 0) + sum(map(_nbytes, ins))
        elif (func.namespace == "aten" and not func.is_view
              and name not in _NO_TRAFFIC):
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.bytes += moved
            if self.in_attention:
                self.attn_bytes += moved
        for t in outs:
            self._track(t)
        return out


@contextlib.contextmanager
def counting(cost: Cost):
    """`cost` on, with DTensor's sharding propagation (which runs fake
    copies of an operation to learn its output's shape) left out, and
    attention's core marked (both by wrapping them for the block)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    prop = DTensor._op_dispatcher.sharding_propagator
    # the entry points DTensor's dispatch calls, by version
    names = [n for n in ("propagate", "propagate_op_sharding",
                         "propagate_op_sharding_non_cached")
             if hasattr(prop, n)]
    saved = {n: getattr(prop, n) for n in names}
    attention = A.blockwise_attention

    def paused(fn):
        # outside the fake mode: DTensor's placement arithmetic builds
        # small index tensors and reads them back, which a fake tensor
        # cannot do; the propagation makes its own fake mode for shapes
        def run(*a, **k):
            cost.paused += 1
            try:
                with unset_fake_temporarily():
                    return fn(*a, **k)
            finally:
                cost.paused -= 1
        return run

    def marked(*a, **k):
        cost.in_attention += 1
        try:
            return attention(*a, **k)
        finally:
            cost.in_attention -= 1

    def real(fn):
        def run(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)
        return run

    # a strided shard's sizes come from an index tensor read back too
    strided = _StridedShard.local_shard_size_and_offset
    for n in names:
        setattr(prop, n, paused(saved[n]))
    A.blockwise_attention = marked
    _StridedShard.local_shard_size_and_offset = real(strided)
    try:
        with cost:
            yield cost
    finally:
        for n in names:
            setattr(prop, n, saved[n])
        A.blockwise_attention = attention
        _StridedShard.local_shard_size_and_offset = strided


def probe_config(cfg, reps: int, attn_impl: str = "naive"):
    """Config with `reps` pattern-repeats, attention in `attn_impl` form,
    every loop unrolled (the reference's probe config)."""
    plen = len(cfg.pattern)
    enc = min(cfg.encoder_layers, reps) if cfg.encoder_layers else 0
    return dataclasses.replace(cfg, n_layers=plen * reps, encoder_layers=enc,
                               unroll=True, attn_impl=attn_impl)


def _env_overrides(cfg):
    """The reference's levers by environment: REPRO_PARAM_DTYPE (e.g.
    bfloat16 params) and REPRO_CAPACITY (the MoE capacity factor)."""
    kw = {}
    if os.environ.get("REPRO_PARAM_DTYPE"):
        kw["param_dtype"] = os.environ["REPRO_PARAM_DTYPE"]
    if os.environ.get("REPRO_CAPACITY"):
        kw["capacity_factor"] = float(os.environ["REPRO_CAPACITY"])
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _local_bytes(t, spec: P, mesh) -> int:
    """Bytes of rank 0's shard of a tensor of `t`'s shape laid out by
    `spec` (DTensor's split: the first shards take the ceiling)."""
    shape = list(t.shape)
    for name, pl in zip(mesh.mesh_dim_names, placements(spec, mesh)):
        if hasattr(pl, "dim"):
            n = dict(zip(mesh.mesh_dim_names, mesh.shape))[name]
            shape[pl.dim] = -(-shape[pl.dim] // n)
    n = 1
    for s in shape:
        n *= s
    return n * t.element_size()


def _fake(struct, dtype=None):
    """A `meta` tree as fake tensors on the CPU (inside FakeTensorMode),
    in `dtype` (default: each leaf's)."""
    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(rec(v) for v in t)
        return torch.empty(t.shape, dtype=dtype or t.dtype)
    return rec(struct)


def _cell_program(cfg, shape, ctx: Ctx):
    """(the step as a function of nothing, the arguments' local bytes):
    the cell's inputs placed by their specs as DTensors of fake tensors.
    Run inside FakeTensorMode and the fake world."""
    mesh = ctx.mesh
    struct = SP.params_struct(cfg)
    pspecs = SP.param_specs(struct, ctx)
    arg_bytes = sum(_local_bytes(t, s, mesh) for t, s in
                    zip(leaves(struct), spec_leaves(pspecs)))
    params = LM(cfg, distribute(_fake(struct), ctx, pspecs))
    if shape.kind == "train":
        f32 = sum(_local_bytes(t.float(), s, mesh) for t, s in
                  zip(leaves(struct), spec_leaves(pspecs)))
        arg_bytes += 2 * f32
        state = TrainState(
            params=params,
            opt=AdamState(m=distribute(_fake(struct, torch.float32), ctx, pspecs),
                          v=distribute(_fake(struct, torch.float32), ctx, pspecs),
                          step=torch.zeros((), dtype=torch.int32)),
            ef=None)
        batch = SP.batch_struct(cfg, shape, train=True)
        arg_bytes += _batch_bytes(batch, ctx)
        fb = _fake(batch)
        return (lambda: train_step(state, fb, cfg, ctx, AdamConfig())), \
            arg_bytes
    if shape.kind == "prefill":
        batch = SP.batch_struct(cfg, shape, train=False)
        arg_bytes += _batch_bytes(batch, ctx)
        fb = _fake(batch)
        return (lambda: prefill(params, fb, cfg, ctx)), arg_bytes
    token, _, cache = SP.decode_structs(cfg, shape)
    b = shape.global_batch
    cspecs = SP.cache_specs(cache, b, ctx)
    arg_bytes += sum(_local_bytes(t, s, mesh) for c, cs in zip(cache, cspecs)
                     for k in sorted(c) for t, s in [(c[k], cs[k])])
    arg_bytes += _local_bytes(token, P(None), mesh)
    fc = tuple(distribute(c, ctx, cs) for c, cs in zip(_fake(cache), cspecs))
    tok = torch.zeros(token.shape, dtype=token.dtype)
    pos = shape.seq_len - 1
    return (lambda: decode_step(params, tok, fc, pos, cfg, ctx)), arg_bytes


def _batch_bytes(batch, ctx: Ctx) -> int:
    specs = SP.batch_specs(batch, ctx)
    return sum(_local_bytes(batch[k], specs[k], ctx.mesh) for k in batch)


def _measure(cfg, shape, multi_pod: bool) -> dict:
    """One traced run of the cell at `cfg`'s depth."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    n = 512 if multi_pod else 256
    with world(n, "fake"):
        mesh = make_production_mesh(multi_pod=multi_pod)
        ctx = make_ctx(mesh)
        with FakeTensorMode():
            t0 = time.perf_counter()
            fn, arg_bytes = _cell_program(cfg, shape, ctx)
            t_lower = time.perf_counter() - t0
            t0 = time.perf_counter()
            with counting(Cost()) as cost:
                out = fn()
                out_bytes = sum(map(_local_nbytes, _tensors(out)))
                del out
            t_compile = time.perf_counter() - t0
    return {"flops": float(cost.flops), "bytes": float(cost.bytes),
            "attn_bytes": float(cost.attn_bytes), "coll": dict(cost.coll),
            "coll_total": float(sum(cost.coll.values())),
            "arg_bytes": arg_bytes, "out_bytes": out_bytes,
            "peak": cost.peak, "t_lower": t_lower, "t_compile": t_compile,
            "chips": n}


def _local_nbytes(t) -> int:
    from torch.distributed.tensor import DTensor

    return _nbytes(t.to_local() if isinstance(t, DTensor) else t)


def measure_cell(arch: str, shape_name: str, *, multi_pod: bool,
                 cfg_override=None) -> dict:
    """The cell's per-device counts: traced at its depth when it has at
    most two pattern repeats, else at 1 and 2 and extrapolated (every
    repeat takes and gives back the residual stream's layout,
    `transformer._residual`, so each costs what the second does)."""
    cfg_full = _env_overrides(cfg_override or get_config(arch))
    shape = SHAPES[shape_name]
    reps = cfg_full.n_layers // len(cfg_full.pattern)
    if reps <= 2:
        return _measure(probe_config(cfg_full, reps), shape, multi_pod)
    p1 = _measure(probe_config(cfg_full, 1), shape, multi_pod)
    p2 = _measure(probe_config(cfg_full, 2), shape, multi_pod)
    extrap = lambda a, b: a + (reps - 1) * (b - a)
    out = dict(p2)
    for k in ("flops", "bytes", "attn_bytes", "coll_total", "peak",
              "arg_bytes", "out_bytes"):
        out[k] = extrap(p1[k], p2[k])
    out["coll"] = {k: extrap(p1["coll"].get(k, 0), p2["coll"].get(k, 0))
                   for k in set(p1["coll"]) | set(p2["coll"])}
    out["t_lower"] = p1["t_lower"] + p2["t_lower"]
    out["t_compile"] = p1["t_compile"] + p2["t_compile"]
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    cfg = _env_overrides(get_config(arch))
    shape = SHAPES[shape_name]
    m = measure_cell(arch, shape_name, multi_pod=multi_pod)
    chips = m["chips"]
    flops_dev = m["flops"] + R.slstm_correction_flops(cfg, shape, chips)
    bytes_naive = m["bytes"]
    has_attn = any(k in ("attn", "mla") for k in cfg.pattern) \
        or cfg.encoder_layers > 0
    bytes_dev = bytes_naive
    if has_attn and shape.kind != "decode":
        bytes_dev = bytes_naive - m["attn_bytes"] \
            + R.flash_bytes(cfg, shape, chips)
    terms = R.roofline_terms(flops_dev, bytes_dev, m["coll_total"], chips)
    mf = R.model_flops(cfg, shape)
    coll = dict(m["coll"], total=m["coll_total"])
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
        "bytes_per_dev_naive_attn": bytes_naive,
        "collective_bytes_per_dev": m["coll_total"],
        "collectives": coll,
        "memory": {"argument_bytes": m["arg_bytes"],
                   "output_bytes": m["out_bytes"],
                   "temp_bytes": max(m["peak"] - m["arg_bytes"], 0),
                   "code_bytes": None,
                   "peak_live_bytes": m["peak"]},
        "model_flops_total": mf,
        "useful_flops_ratio": mf / max(flops_dev * chips, 1e-30),
        "lower_s": m["t_lower"], "compile_s": m["t_compile"],
        "params": R.param_count(cfg),
        "params_active": R.param_count(cfg, active_only=True),
        **terms,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in shapes_for(arch):
                cells.append((arch, shape, False))
                cells.append((arch, shape, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        if args.shape in SKIPS.get(args.arch, {}):
            print(f"SKIP {args.arch} {args.shape}: "
                  f"{SKIPS[args.arch][args.shape]}")
            return
        cells.append((args.arch, args.shape, args.multipod))

    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"cached {tag}")
            continue
        print(f"=== {tag} ===", flush=True)
        try:
            res = run_cell(arch, shape, multi_pod=mp)
            print(json.dumps({k: v for k, v in res.items()
                              if k not in ("collectives", "memory")},
                             indent=None, default=str), flush=True)
            with open(path, "w") as f:
                json.dump(res, f, indent=1, default=str)
        except Exception:
            traceback.print_exc()
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())


if __name__ == "__main__":
    main()
