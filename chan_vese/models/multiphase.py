"""Multiphase Vese-Chan segmentation (SURVEY.md C10, §3.3; B:9).

M coupled level sets partition the image into 2^M phases (Vese & Chan 2002,
"A Multiphase Level Set Framework..."). Energy:

    F = sum_s  int (u0 - c_s)^2 w_s  +  mu sum_m Length(phi_m)
    w_s = prod_m [ H(phi_m) if s_m else (1 - H(phi_m)) ],  s in {0,1}^M

Gradient flow for phi_m (the coupling term of §3.3 for M = 2):

    dphi_m/dt = delta(phi_m) [ mu kappa(phi_m) - nu
                  - sum_{s: s_m=1} (u0-c_s)^2 prod_{k!=m} w-factor_k
                  + sum_{s: s_m=0} (u0-c_s)^2 prod_{k!=m} w-factor_k ]

Each phi_m is advanced by the same semi-implicit sweep as the scalar model
(ops/sweep.py), with the data term f_m built from the *current* state:
sweeps are sequential over m within an iteration (phi_1's sweep sees
phi_0's updated Heaviside), and the 2^M phase means are computed once per
outer iteration - "two coupled GS sweeps + 4 reductions per iteration" for
M = 2, exactly the structure SURVEY.md §3.3 describes.

Vector-valued (H, W, C) images are supported: phase means are per-channel
and squared distances average over channels.

Everything is a fixed-M python loop over vectorized full-grid ops - under
jit this unrolls into one program with no dynamic shapes.
The M phis are carried as a single (M, H, W) array so the batched/sharded
paths treat multiphase transparently.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.numerics import heaviside
from ..ops.reductions import loop_continue
from ..ops.sweep import semi_implicit_step
from ..params import CVParams
from ..utils.init_phi import checkerboard, circle


def _sqdist(u0, c):
    """(u0 - c)^2, channel-averaged for vector-valued images."""
    if u0.ndim == 3:
        return jnp.mean((u0 - c) ** 2, axis=-1)
    return (u0 - c) ** 2


def phase_weights(phis, eps: float):
    """The 2^M soft phase indicators w_s, ordered by bitmask s.

    Bit m of s set <=> inside phi_m (H factor), else (1 - H).
    Returns a list of (H, W) arrays, length 2^M.
    """
    m_sets = phis.shape[0]
    hs = [heaviside(phis[m], eps) for m in range(m_sets)]
    ws = []
    for s in range(2 ** m_sets):
        w = None
        for m in range(m_sets):
            factor = hs[m] if (s >> m) & 1 else (1.0 - hs[m])
            w = factor if w is None else w * factor
        ws.append(w)
    return ws


def phase_means(u0, phis, eps: float):
    """Means c_s of u0 over each soft phase (per-channel for RGB)."""
    ws = phase_weights(phis, eps)
    tiny = 1e-30
    cs = []
    for w in ws:
        if u0.ndim == 3:
            num = jnp.sum(u0 * w[..., None], axis=(0, 1))
            den = jnp.maximum(jnp.sum(w), tiny)
        else:
            num = jnp.sum(u0 * w)
            den = jnp.maximum(jnp.sum(w), tiny)
        cs.append(num / den)
    return cs


def _coupling_term(u0, phis, cs, m: int, p: CVParams):
    """Data-fitting force on phi_m given all current level sets.

    ``phis``: stacked (M, H, W) array or a length-M sequence of (H, W).
    """
    m_sets = len(phis)
    f = jnp.zeros(u0.shape[:2], dtype=phis[0].dtype)
    hs = [heaviside(phis[k], p.eps) for k in range(m_sets)]
    for s in range(2 ** m_sets):
        d = _sqdist(u0, cs[s])
        w_other = None
        for k in range(m_sets):
            if k == m:
                continue
            factor = hs[k] if (s >> k) & 1 else (1.0 - hs[k])
            w_other = factor if w_other is None else w_other * factor
        if w_other is None:  # M == 1
            w_other = jnp.ones_like(f)
        sign = -1.0 if (s >> m) & 1 else 1.0
        f = f + sign * d * w_other
    return f - p.nu


def multiphase_step(phis, u0, p: CVParams):
    """One outer iteration: 2^M means, then M sequential sweeps."""
    cs = phase_means(u0, phis, p.eps)
    # work on a list of (H, W) level sets and stack once, so each sweep
    # reads the previous level sets' updated values without rewriting
    # the stacked (M, H, W) array per level set
    new = [phis[m] for m in range(phis.shape[0])]
    for m in range(phis.shape[0]):
        f = _coupling_term(u0, new, cs, m, p)
        new[m] = semi_implicit_step(new[m], f, p)
    return jnp.stack(new), cs


def _maybe_reinit_phis(phis, n, p: CVParams):
    """Redistance every level set every p.reinit_every iterations."""
    from ..ops.reinit import maybe_reinit

    return maybe_reinit(phis, n, p)


def multiphase_energy(u0, phis, p: CVParams):
    """F = sum_s fit_s + mu sum_m Length(phi_m) + nu sum_m Area(phi_m)."""
    from ..ops.numerics import dirac, grad_forward

    cs = phase_means(u0, phis, p.eps)
    ws = phase_weights(phis, p.eps)
    fit = jnp.zeros((), dtype=phis.dtype)
    for w, c in zip(ws, cs):
        fit = fit + jnp.sum(_sqdist(u0, c) * w)
    reg = jnp.zeros((), dtype=phis.dtype)
    for m in range(phis.shape[0]):
        gx, gy = grad_forward(phis[m])
        reg = reg + p.mu * jnp.sum(dirac(phis[m], p.eps)
                                   * jnp.sqrt(gx * gx + gy * gy))
        reg = reg + p.nu * jnp.sum(heaviside(phis[m], p.eps))
    return fit + reg


def labels_from_phis(phis):
    """Phase label map: bit m set where phi_m >= 0 (SURVEY.md §3.3)."""
    lab = jnp.zeros(phis.shape[1:], dtype=jnp.int32)
    for m in range(phis.shape[0]):
        lab = lab | ((phis[m] >= 0).astype(jnp.int32) << m)
    return lab


def init_multiphase(shape, m_sets: int = 2, kind: str = "checkerboard",
                    dtype=jnp.float32):
    """Default multiphase init: phase-shifted checkerboards.

    Checkerboard (default) puts zero contours everywhere, so convergence is
    independent of image size (contours move O(1) px per sweep - a circle
    init on a 512^2 image needs hundreds of iterations just to travel);
    'circles' uses staggered circles (useful to pin label polarity).
    """
    if kind == "checkerboard":
        base = checkerboard(shape, dtype)
        phis = [base]
        for m in range(1, m_sets):
            # shift by a fraction of the period per extra level set so all
            # 2^M phase combinations are seeded
            rolled = jnp.roll(base, shift=(5 * m) // 2 + 1, axis=1)
            phis.append(rolled)
        return jnp.stack(phis)
    if kind != "circles":
        raise ValueError(f"unknown multiphase init {kind!r}")
    h, w = shape
    phis = []
    for m in range(m_sets):
        cy = h * (0.35 + 0.3 * (m % 2))
        cx = w * (0.35 + 0.3 * ((m // 2) % 2))
        phis.append(circle(shape, dtype, center=(cy, cx),
                           radius=min(h, w) / 3.5))
    return jnp.stack(phis)


class MultiphaseResult(NamedTuple):
    phis: jax.Array     # (M, H, W)
    labels: jax.Array   # (H, W) int32 phase labels
    iters: jax.Array
    delta: jax.Array
    cs: jax.Array       # (2^M, ...) phase means


@functools.partial(jax.jit,
                   static_argnames=("p", "m_sets", "fixed", "max_iter"))
def segment_multiphase(u0, p: CVParams = CVParams(), m_sets: int = 2,
                       phis0: Optional[jax.Array] = None,
                       fixed: bool = False,
                       max_iter: Optional[int] = None) -> MultiphaseResult:
    """Segment into 2^m_sets phases; converges on label-flip fraction.

    ``fixed=True`` runs exactly ``max_iter`` (or p.max_iter) iterations.
    """
    cap = p.max_iter if max_iter is None else max_iter
    if phis0 is None:
        phis0 = init_multiphase(u0.shape[:2], m_sets, dtype=u0.dtype)

    def cond(state):
        _, n, delta, streak = state
        if fixed:
            return n < cap
        return loop_continue(n, delta, streak, p, cap)

    def body(state):
        phis, n, _, streak = state
        new, _ = multiphase_step(phis, u0, p)
        # 0 * sum(new) NaN-poisons the label-flip metric when a level
        # set went non-finite (labels of NaN phis are finite garbage),
        # so loop_continue's divergence abort fires
        flips = (jnp.mean((labels_from_phis(new)
                           != labels_from_phis(phis)).astype(u0.dtype))
                 + 0.0 * jnp.sum(new))
        new = _maybe_reinit_phis(new, n, p)
        streak = jnp.where(flips < p.tol, streak + 1, 0)
        return (new, n + 1, flips, streak)

    init = (phis0, jnp.int32(0), jnp.asarray(jnp.inf, phis0.dtype),
            jnp.int32(0))
    phis, iters, delta, _ = jax.lax.while_loop(cond, body, init)
    cs = jnp.stack(phase_means(u0, phis, p.eps))
    return MultiphaseResult(phis, labels_from_phis(phis), iters, delta, cs)


class MultiphaseTrace(NamedTuple):
    phis: jax.Array
    labels: jax.Array
    energy: jax.Array
    delta: jax.Array


@functools.partial(jax.jit, static_argnames=("p", "iters", "m_sets"))
def segment_multiphase_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                             m_sets: int = 2,
                             phis0: Optional[jax.Array] = None
                             ) -> MultiphaseTrace:
    """Fixed-iteration run with per-iteration energy/flip traces.

    This is the parity/diagnostic entry point. For throughput
    benchmarking use ``segment_multiphase(..., fixed=True)`` - the
    per-iteration energy evaluation here costs as much as the iteration
    itself (SURVEY.md §3.1 marks energy logging optional).
    """
    if phis0 is None:
        phis0 = init_multiphase(u0.shape[:2], m_sets, dtype=u0.dtype)

    def body(carry, _):
        phis, n = carry
        new, _ = multiphase_step(phis, u0, p)
        flips = jnp.mean((labels_from_phis(new)
                          != labels_from_phis(phis)).astype(u0.dtype))
        e = multiphase_energy(u0, new, p)
        new = _maybe_reinit_phis(new, n, p)
        return (new, n + 1), (e, flips)

    (phis, _), (es, ds) = jax.lax.scan(body, (phis0, jnp.int32(0)), None,
                                       length=iters)
    return MultiphaseTrace(phis, labels_from_phis(phis), es, ds)
