"""Holding two runs of the same training step against each other (the
card against the CPU, the port against the reference carried across by
`models.weights.train_state_from_reference`).

Two runs whose arithmetic adds in different orders agree to float32
rounding: gradients within GRAD_REL of their leaf's largest |gradient|
plus GRAD_ABS, states within RTOL / ATOL.  The step is not continuous in
its gradients in two places, and there the comparison follows what the
arithmetic allows:

- Adam divides each element's gradient by its root mean square, so
  where that root is small against the two runs' gradient difference
  the update's direction is not determined: an element whose gradient
  is float32 noise (zero in exact arithmetic: a key bias on the
  dimensions RoPE leaves unrotated shifts every score of a query alike,
  which the softmax ignores) moves by up to lr in a direction the noise
  picks, and a small gradient in a long recurrence (xLSTM) turns a
  difference of float32 rounding into a visible one.  Where the two
  states' own moments give directions m-hat / (sqrt(v-hat) + eps) more
  than DIRECTION_TOL apart, a param is held to twice the learning rates
  summed over the steps, plus ATOL (each run moves it at most about lr
  a step); the moments themselves are held within RTOL / ATOL;
- int8 compression rounds g / scale to an integer, so an element on a
  rounding boundary (k + 1/2) rounds to k in one run and to k + 1 in the
  other.  Such an element shows as error-feedback residuals of opposite
  sign, +-scale/2 (opposite to within FLIP_RTOL, or given the gradients'
  scale to within twice the gradient tolerance, as below); it is
  counted, held to at most FLIP_SHARE of its leaf (counted as of a leaf
  of at least 1,000) and left out of its leaf's params (held as above),
  `m`, `v` and `ef`.  Elsewhere a residual is the gradient less q times
  the leaf's scale (its largest |gradient| / 127), so the runs' residuals
  differ by their gradients' difference and by q times their scales'
  difference, each within the gradient tolerance: given the gradients'
  scale, `ef` is held to twice the gradient tolerance beside RTOL / ATOL.

An element apart at one step stays apart at the next (`before`).  A
failed comparison raises AssertionError naming the leaf.
"""
from __future__ import annotations

import torch

from repro_torch.models.tree import leaves

RTOL, ATOL = 1e-4, 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
DIRECTION_TOL = 1e-2
# two residuals across a boundary are (1/2 + e) s and -(1/2 - e') s, e
# and e' the two runs' gradients' distances from it in quanta: up to
# 127 times their relative difference (xLSTM's card against the CPU:
# some 6e-6), so opposite to within 2 (e + e') < 1e-2
FLIP_RTOL = 1e-2
# gradients within GRAD_REL of their leaf's largest are within 127e-4 of
# a quantum of each other: up to some 1.3 % of a leaf's elements may
# round apart (Jamba's port against the reference: 10 of 8,192 at step 2)
FLIP_SHARE = 2e-2


def _host(tree):
    return [x.detach().cpu() for x in leaves(tree)]


def compare_grads(got, want, what: str = "") -> float:
    """Every leaf of `got` within GRAD_REL of its leaf's largest |want|
    plus GRAD_ABS.  Returns the largest error over its leaf's scale."""
    worst = 0.0
    g_l, w_l = _host(got), _host(want)
    if len(g_l) != len(w_l):
        raise AssertionError(f"{what}: {len(g_l)} against {len(w_l)} leaves")
    for i, (g, w) in enumerate(zip(g_l, w_l)):
        if g.shape != w.shape or not bool(g.isfinite().all()):
            raise AssertionError(f"{what}: gradient leaf {i} {g.shape}")
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        if err > GRAD_REL * scale + GRAD_ABS:
            raise AssertionError(f"{what}: gradient leaf {i} off by "
                                 f"{err:.3g} at scale {scale:.3g}")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def compare_states(got, want, opt_cfg, *, before: dict | None = None,
                   grad_scale=None, what: str = "") -> dict:
    """Params, `m`, `v`, `step` and `ef` of the TrainState `got` against
    `want` (any devices), as the module docstring sets out.  `before` is
    what this returned for the states one step earlier, when both runs
    took that step too.  `grad_scale`: for a state with `ef`, each leaf's
    largest |gradient| that its step compressed (in `leaves` order).
    Returns {"rounded": masks of the elements rounded apart so far,
    "loose": masks of the params apart so far, "int8_apart": the number
    rounded apart at this step}."""
    step = int(want.opt.step)
    if int(got.opt.step) != step:
        raise AssertionError(f"{what}: step {int(got.opt.step)} against "
                             f"{step}")
    if (got.ef is None) != (want.ef is None):
        raise AssertionError(f"{what}: error feedback in one state only")
    lr_sum = sum(opt_cfg.lr * min(1.0, k / opt_cfg.warmup)
                 for k in range(1, step + 1))
    m_got, m_want = _host(got.opt.m), _host(want.opt.m)

    def directions(ms, st):
        return [(m / (1 - opt_cfg.b1 ** step))
                / ((v / (1 - opt_cfg.b2 ** step)).sqrt() + opt_cfg.eps)
                for m, v in zip(ms, _host(st.opt.v))]

    d_got, d_want = directions(m_got, got), directions(m_want, want)
    # how far apart two residuals may be: twice the gradient tolerance
    ef_tol = ([2 * (GRAD_REL * s + GRAD_ABS) for s in grad_scale]
              if grad_scale is not None else None)
    rounded = (list(before["rounded"]) if before
               else [torch.zeros_like(m, dtype=torch.bool) for m in m_want])
    flips = 0
    if want.ef is not None:
        for i, (g, w) in enumerate(zip(_host(got.ef), _host(want.ef))):
            tol = ATOL + ef_tol[i] if ef_tol else ATOL
            opposite = ((g + w).abs() <= ef_tol[i] if ef_tol
                        else torch.isclose(g, -w, rtol=FLIP_RTOL, atol=0))
            f = ~torch.isclose(g, w, rtol=RTOL, atol=tol) & opposite
            if int(f.sum()) > FLIP_SHARE * max(w.numel(), 1000):
                raise AssertionError(f"{what}: {int(f.sum())} of "
                                     f"{w.numel()} int8 roundings apart")
            rounded[i] = rounded[i] | f
            flips += int(f.sum())
    prev = before["loose"] if before else rounded
    loose = [r | p | (dg - dw).abs().gt(DIRECTION_TOL)
             for r, p, dg, dw in zip(rounded, prev, d_got, d_want)]
    for name, g_t, w_t in (("params", got.params, want.params),
                           ("m", got.opt.m, want.opt.m),
                           ("v", got.opt.v, want.opt.v),
                           ("ef", got.ef, want.ef)):
        if w_t is None:
            continue
        g_l, w_l = _host(g_t), _host(w_t)
        if len(g_l) != len(w_l):
            raise AssertionError(f"{what}: {name} has {len(g_l)} leaves "
                                 f"against {len(w_l)}")
        for i, (g, w) in enumerate(zip(g_l, w_l)):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{what}: {name} leaf {i} {g.shape} "
                                     f"{g.dtype} against {w.shape} "
                                     f"{w.dtype}")
            keep = ~rounded[i]
            tol = ATOL + ef_tol[i] if name == "ef" and ef_tol else ATOL
            if name == "params":
                if not bool(((g - w).abs()[loose[i]]
                             <= 2 * lr_sum + ATOL).all()):
                    raise AssertionError(f"{what}: params leaf {i}: beyond "
                                         "the steps' moves")
                keep = ~loose[i]
            bad = keep & ~torch.isclose(g, w, rtol=RTOL, atol=tol)
            if bad.any():
                j = int(bad.flatten().nonzero()[0])
                at = {k: float(t.flatten()[j]) for k, t in (
                    ("got", g), ("want", w), ("m_got", m_got[i]),
                    ("m_want", m_want[i]), ("d_got", d_got[i]),
                    ("d_want", d_want[i]))}
                raise AssertionError(f"{what}: {name} leaf {i}: "
                                     f"{int(bad.sum())} elements apart, the "
                                     f"first {at}")
    return {"rounded": rounded, "loose": loose, "int8_apart": flips}
