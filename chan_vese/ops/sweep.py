"""Semi-implicit level-set sweeps (the hot loop, SURVEY.md C4-C6, §3.1).

One update expression, three schedules:

  * ``jacobi_step``    - all cells from old values (fully parallel).
  * ``redblack_step``  - two vectorized half-sweeps: the red half (global
    (i + j) even) updates from all-old values, the black half from red-new +
    black-old. Same fixed point as sequential raster Gauss-Seidel
    (BASELINE.json north star: "semi-implicit Gauss-Seidel sweep recast as
    red-black ordering for vectorization"); this is the fast path every
    driver runs.
  * ``wavefront_step`` - reproduces sequential *raster* Gauss-Seidel
    EXACTLY: raster order updates cell (i, j) reading new values at
    (i-1, j-1), (i-1, j), (i-1, j+1), (i, j-1) and old values elsewhere, so
    the skewed diagonals d = 2 i + j are an exact parallel schedule (every
    new-value read lands on d' < d, every old-value read on d' > d; proof in
    tests/test_sweep.py). 2 H + W - 2 masked steps - parity mode only.

The per-cell update (SURVEY.md §3.1; Chan & Vese 2001 §4):

    phi'[i,j] = ( phi[i,j] + dt d ( A phi[i+1,j] + A- phi[i-1,j]
                + B phi[i,j+1] + B- phi[i,j-1] + f[i,j] ) )
              / ( 1 + dt d (A + A- + B + B-) )

with d = delta_eps(phi[i,j]), face coefficients A/B from
:func:`..numerics.face_coeffs`, A- = A shifted down (A[i-1,j], clamped), B-
= B shifted right (B[i,j-1], clamped), and clamped neighbor values
(Neumann). f is the data-fitting force (scalar, vector-valued, or
multiphase coupling) - precomputed because it does not depend on phi.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .numerics import (dirac, face_coeffs_all, shift_down, shift_left,
                       shift_right, shift_up)


def _update_all(phi, f, mu, dt, eps, eta2):
    """The semi-implicit update evaluated at every cell from state ``phi``."""
    A, B, Am, Bm = face_coeffs_all(phi, mu, eta2)
    d = dirac(phi, eps)
    num = phi + dt * d * (A * shift_down(phi) + Am * shift_up(phi)
                          + B * shift_right(phi) + Bm * shift_left(phi) + f)
    den = 1.0 + dt * d * (A + Am + B + Bm)
    return num / den


def color_masks(shape, parity: int = 0, dtype=jnp.bool_):
    """Red mask ((i + j + parity) % 2 == 0) in *global* coordinates.

    ``parity`` lets a sharded tile align its local lattice with the global
    one: pass (row0 + col0) % 2 of the tile origin.
    """
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return (((i + j + parity) % 2) == 0).astype(dtype)


def jacobi_step(phi, f, p):
    """Fully parallel semi-implicit update (all neighbors old)."""
    return _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2)


def redblack_step(phi, f, p, parity: int = 0):
    """Red half-sweep from old values, then black from red-new values."""
    red = color_masks(phi.shape, parity)
    phi = jnp.where(red, _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2), phi)
    phi = jnp.where(red, phi, _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2))
    return phi


def wavefront_step(phi, f, p):
    """Exact sequential raster Gauss-Seidel via skewed diagonals d = 2i + j.

    O((2H + W) * H * W) work - for parity tests and small grids only.
    """
    h, w = phi.shape
    i = jax.lax.broadcasted_iota(jnp.int32, phi.shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, phi.shape, 1)
    diag = 2 * i + j

    def body(d, cur):
        upd = _update_all(cur, f, p.mu, p.dt, p.eps, p.eta2)
        return jnp.where(diag == d, upd, cur)

    return jax.lax.fori_loop(0, 2 * (h - 1) + (w - 1) + 1, body, phi)


def semi_implicit_step(phi, f, p, parity: int = 0):
    """Dispatch on p.order ('redblack' | 'jacobi' | 'wavefront')."""
    if p.order == "redblack":
        return redblack_step(phi, f, p, parity)
    if p.order == "jacobi":
        return jacobi_step(phi, f, p)
    if p.order == "wavefront":
        return wavefront_step(phi, f, p)
    raise ValueError(f"unknown sweep order {p.order!r}")
