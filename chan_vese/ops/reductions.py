"""Global reductions: region means, energy, convergence norms.

These are the ``psum``-ready reductions of the framework (SURVEY.md C3, C8,
C16). Each has a raw-sums form so the sharded path (parallel/sharded.py)
can ``jax.lax.psum`` per-device partials across the mesh instead of
gathering pixels.

All reductions accumulate in f32 on the accelerator (XLA reduces
tree-wise) and in f64 under the CPU/x64 parity mode; the energy-trace parity tests (<=1e-5,
BASELINE.json:5) run the f32 path against the f64 golden.
"""

from __future__ import annotations

import jax.numpy as jnp

from .numerics import dirac, grad_forward, heaviside


def region_sums(u0, phi, eps: float):
    """Masked sums behind the region means.

    Returns (sum_uH, sum_H, sum_u, n) where H = H_eps(phi). For
    multi-channel u0 of shape (H, W, C) against phi of shape (H, W), the
    per-channel sums have shape (C,).

    c1 = sum_uH / sum_H ; c2 = (sum_u - sum_uH) / (n - sum_H).
    """
    h = heaviside(phi, eps)
    if u0.ndim == phi.ndim + 1:
        hh = h[..., None]
        axes = tuple(range(phi.ndim))
        sum_uh = jnp.sum(u0 * hh, axis=axes)
        sum_u = jnp.sum(u0, axis=axes)
    else:
        sum_uh = jnp.sum(u0 * h)
        sum_u = jnp.sum(u0)
    sum_h = jnp.sum(h)
    n = jnp.asarray(phi.size, dtype=phi.dtype)
    return sum_uh, sum_h, sum_u, n


def means_from_sums(sum_uh, sum_h, sum_u, n):
    """c1, c2 from region sums (safe against empty regions)."""
    tiny = jnp.asarray(1e-30, dtype=sum_h.dtype)
    c1 = sum_uh / jnp.maximum(sum_h, tiny)
    c2 = (sum_u - sum_uh) / jnp.maximum(n - sum_h, tiny)
    return c1, c2


def region_means(u0, phi, eps: float):
    """Region averages c1 (inside, phi >= 0 side) and c2 (outside).

    SURVEY.md C3: c1 = <u0 H_eps(phi)> / <H_eps(phi)>, c2 with (1 - H_eps).
    Per-channel for (H, W, C) inputs.
    """
    return means_from_sums(*region_sums(u0, phi, eps))


def data_term(u0, c1, c2, nu: float, lambda1, lambda2):
    """Pointwise data-fitting force f (SURVEY.md C6).

    Scalar:  f = -nu - lambda1 (u0 - c1)^2 + lambda2 (u0 - c2)^2.
    Vector-valued (u0: (H, W, C), c: (C,), lambda: (C,)):
        f = -nu - (1/C) sum_ch l1[ch] (u0-c1)[ch]^2
                + (1/C) sum_ch l2[ch] (u0-c2)[ch]^2
    (Chan-Sandberg-Vese 2000; SURVEY.md §3.2.)
    """
    if u0.ndim == 3:
        l1 = jnp.asarray(lambda1, dtype=u0.dtype)
        l2 = jnp.asarray(lambda2, dtype=u0.dtype)
        d1 = jnp.mean(l1 * (u0 - c1) ** 2, axis=-1)
        d2 = jnp.mean(l2 * (u0 - c2) ** 2, axis=-1)
    else:
        d1 = lambda1 * (u0 - c1) ** 2
        d2 = lambda2 * (u0 - c2) ** 2
    return -nu - d1 + d2


def energy(u0, phi, c1, c2, p, lambda1=None, lambda2=None):
    """Chan-Vese energy functional F (SURVEY.md C16).

    F = mu sum delta_eps(phi) |grad phi|
      + nu sum H_eps(phi)
      + lambda1 sum (u0 - c1)^2 H_eps(phi)
      + lambda2 sum (u0 - c2)^2 (1 - H_eps(phi))

    |grad phi| uses forward differences with clamped last row/col. For the
    vector-valued case pass per-channel lambda1/lambda2 sequences (defaults
    broadcast p.lambda1/p.lambda2) and the fitting terms average over
    channels, matching :func:`data_term`.
    """
    l1 = p.lambda1 if lambda1 is None else lambda1
    l2 = p.lambda2 if lambda2 is None else lambda2
    h = heaviside(phi, p.eps)
    gx, gy = grad_forward(phi)
    length = jnp.sum(dirac(phi, p.eps) * jnp.sqrt(gx * gx + gy * gy))
    area = jnp.sum(h)
    if u0.ndim == 3:
        l1 = jnp.broadcast_to(jnp.asarray(l1, dtype=u0.dtype), (u0.shape[-1],))
        l2 = jnp.broadcast_to(jnp.asarray(l2, dtype=u0.dtype), (u0.shape[-1],))
        fit1 = jnp.sum(jnp.mean(l1 * (u0 - c1) ** 2, axis=-1) * h)
        fit2 = jnp.sum(jnp.mean(l2 * (u0 - c2) ** 2, axis=-1) * (1.0 - h))
        return p.mu * length + p.nu * area + fit1 + fit2
    fit1 = jnp.sum((u0 - c1) ** 2 * h)
    fit2 = jnp.sum((u0 - c2) ** 2 * (1.0 - h))
    return p.mu * length + p.nu * area + l1 * fit1 + l2 * fit2


def delta_norm(phi_new, phi_old, kind: str = "flips"):
    """Per-pixel convergence metric of the update (SURVEY.md C8).

    'rms' / 'mean_abs' are the classic per-pixel tolerances on delta-phi
    (intensity-scale dependent: phi drifts ~t^(1/3) in settled regions, so
    its update norm decays only like t^(-2/3) - pick tol accordingly).
    'flips' (default) is the scale-invariant criterion: the fraction of
    pixels whose mask sign changed this iteration; at the canonical
    operating point segmentations typically reach 0 flips within tens of
    iterations while delta-phi is still drifting.
    """
    d = phi_new - phi_old
    if kind == "flips":
        flipped = (phi_new >= 0) != (phi_old >= 0)
        # NaN-poison: comparisons against a NaN phi are all-False, so the
        # flip count alone would report a garbage state as "converged".
        # 0 * sum(d) is 0 for finite updates and NaN when phi went
        # NaN/Inf, which loop_continue treats as divergence.
        return jnp.mean(flipped.astype(phi_new.dtype)) + 0.0 * jnp.sum(d)
    if kind == "rms":
        return jnp.sqrt(jnp.mean(d * d))
    if kind == "mean_abs":
        return jnp.mean(jnp.abs(d))
    raise ValueError(f"unknown conv_norm {kind!r}")


def loop_continue(n, delta, streak, p, max_iter=None):
    """Shared tolerance-loop predicate for every driver's while_loop.

    Continue while (a) under the iteration cap, (b) not yet converged -
    the update metric must stay below tol for ``p.patience`` consecutive
    iterations (the ``streak`` counter) and at least ``p.min_iter``
    iterations have run - and (c) not diverged: a non-finite delta (NaN,
    or +Inf from e.g. an rms norm overflowing) means phi went non-finite
    (bad input / unstable parameters), and the loop aborts immediately
    instead of burning the remaining iterations (failure detection,
    SURVEY.md §5). The initial delta is +inf by convention, so the
    divergence test is gated on n > 0 (iteration 0 always runs).
    """
    cap = p.max_iter if max_iter is None else max_iter
    done = jnp.logical_and(streak >= p.patience, n >= p.min_iter)
    diverged = jnp.logical_and(n > 0,
                               jnp.logical_not(jnp.isfinite(delta)))
    return jnp.logical_and(n < cap,
                           jnp.logical_not(jnp.logical_or(done, diverged)))
