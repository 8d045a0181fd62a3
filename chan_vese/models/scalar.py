"""Scalar (grayscale) Chan-Vese segmentation driver (SURVEY.md L3, §3.1).

Structure: the whole outer iteration is a device-side
``lax.while_loop`` (tolerance mode) or ``lax.scan`` (fixed-iteration /
trace mode) under one ``jit`` - control crosses host->device exactly once
per segmentation. Per iteration:

    c1, c2 = region_means(u0, phi)         # fused masked reductions
    f      = data_term(u0, c1, c2, ...)    # pointwise
    phi    = semi_implicit_step(phi, f)    # red-black (default) sweep
    delta  = ||phi' - phi|| per pixel      # convergence (SURVEY.md C8)

Public surface mirrors the reference's single entry point
``segment(image, params) -> phi/mask`` (SURVEY.md §1 L3).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.reductions import (data_term, delta_norm, energy, loop_continue,
                              region_means)
from ..ops.reinit import maybe_reinit as _maybe_reinit
from ..ops.sweep import semi_implicit_step
from ..params import CVParams
from ..utils.init_phi import init_phi


class SegResult(NamedTuple):
    phi: jax.Array      # final level set (H, W)
    mask: jax.Array     # phi >= 0 (bool)
    iters: jax.Array    # iterations actually run (int32 scalar)
    delta: jax.Array    # final per-pixel update norm
    c1: jax.Array       # inside mean(s)
    c2: jax.Array       # outside mean(s)


def step(phi, u0, p: CVParams, lambda1=None, lambda2=None, parity: int = 0):
    """One full Chan-Vese iteration; returns (phi_new, c1, c2, delta)."""
    c1, c2 = region_means(u0, phi, p.eps)
    l1 = p.lambda1 if lambda1 is None else jnp.asarray(lambda1, phi.dtype)
    l2 = p.lambda2 if lambda2 is None else jnp.asarray(lambda2, phi.dtype)
    f = data_term(u0, c1, c2, p.nu, l1, l2)
    phi_new = semi_implicit_step(phi, f, p, parity)
    return phi_new, c1, c2, delta_norm(phi_new, phi, p.conv_norm)


@functools.partial(jax.jit, static_argnames=("p", "lambda1", "lambda2"))
def segment(u0, p: CVParams = CVParams(), phi0: Optional[jax.Array] = None,
            lambda1=None, lambda2=None) -> SegResult:
    """Segment to convergence (per-pixel tol) or max_iter, fully on device.

    Works for grayscale (H, W) and vector-valued (H, W, C) images alike
    (Chan-Sandberg-Vese for the latter; SURVEY.md C9 / §3.2); pass
    per-channel weight tuples via lambda1/lambda2 for the weighted
    vector-valued energy.
    """
    phi0 = init_phi(u0.shape[:2], p.init, u0.dtype) if phi0 is None else phi0

    def cond(state):
        phi, n, delta, streak = state
        return loop_continue(n, delta, streak, p)

    def body(state):
        phi, n, _, streak = state
        phi_new, _, _, delta = step(phi, u0, p, lambda1, lambda2)
        phi_new = _maybe_reinit(phi_new, n, p)
        streak = jnp.where(delta < p.tol, streak + 1, 0)
        return (phi_new, n + 1, delta, streak)

    init = (phi0, jnp.int32(0), jnp.asarray(jnp.inf, phi0.dtype),
            jnp.int32(0))
    phi, iters, delta, _ = jax.lax.while_loop(cond, body, init)
    c1, c2 = region_means(u0, phi, p.eps)
    return SegResult(phi, phi >= 0, iters, delta, c1, c2)


class SegTrace(NamedTuple):
    phi: jax.Array
    mask: jax.Array
    energy: jax.Array   # (iters,) energy after each iteration
    delta: jax.Array    # (iters,) update norm of each iteration
    c1: jax.Array       # (iters, ...) means used by each iteration
    c2: jax.Array


@functools.partial(jax.jit,
                   static_argnames=("p", "iters", "lambda1", "lambda2"))
def segment_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                  phi0: Optional[jax.Array] = None,
                  lambda1=None, lambda2=None, start_iter=0) -> SegTrace:
    """Fixed-iteration segmentation returning the per-iteration energy trace.

    The trace (energy after each sweep, evaluated with means recomputed
    from the post-sweep phi) is the parity artifact of BASELINE.json:5
    ("energy-trace agreement <=1e-5 at fixed iteration count"); the same
    convention is implemented by the native C baseline.
    """
    phi0 = init_phi(u0.shape[:2], p.init, u0.dtype) if phi0 is None else phi0

    def body(carry, _):
        phi, n = carry
        phi_new, c1, c2, delta = step(phi, u0, p, lambda1, lambda2)
        c1n, c2n = region_means(u0, phi_new, p.eps)
        e = energy(u0, phi_new, c1n, c2n, p, lambda1, lambda2)
        phi_new = _maybe_reinit(phi_new, n, p)
        return (phi_new, n + 1), (e, delta, c1, c2)

    (phi, _), (es, ds, c1s, c2s) = jax.lax.scan(
        body, (phi0, jnp.asarray(start_iter, jnp.int32)), None,
        length=iters)
    return SegTrace(phi, phi >= 0, es, ds, c1s, c2s)
