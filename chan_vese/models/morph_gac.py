"""Morphological geodesic active contours (MorphGAC) driver.

L3 driver over ops/morph.py's GAC operators: the morphological
approximation of the geodesic-active-contour flow (Marquez-Neila,
Baumela, Alvarez, PAMI 2014 - the algorithm scikit-image ships as
``morphological_geodesic_active_contour``). Unlike the ACWE/Chan-Vese
family, GAC segments a PREPROCESSED edge map g (inverse_gaussian_gradient
of the image: ~1 in flat regions, ~0 on edges), not the raw intensities:

    balloon     grow (dilate) or shrink (erode) the binary region where
                g is above threshold/|balloon| (far from any edge)
    attraction  move contour pixels along grad(g) (snap onto edges)
    smoothing   the shared alternating SIoIS / ISoSI cycles

Everything is neighbor-shift + min/max + elementwise arithmetic on a
binary plane - the same fully-fusable program class as MorphACWE, and
(notably) with NO global reductions inside the loop: the iteration is
purely local, so the GSPMD-sharded twin needs only halo exchanges, never
an all-reduce. The edge-map gradient and balloon mask are loop
invariants, computed once and closed over by the compiled loop.

The reference mount is empty (SURVEY.md Section 0); this family is a
rebuild-side capability completing the scikit-image compat surface
(compat.morphological_geodesic_active_contour mirrors the signature).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.morph import gac_step, smooth
from ..ops.reductions import loop_continue
from ..params import CVParams
from ..utils.init_phi import init_phi


class GACResult(NamedTuple):
    ls: jax.Array     # final binary level set (H, W), values {0.0, 1.0}
    mask: jax.Array   # ls >= 0.5 (bool)
    iters: jax.Array  # iterations actually run (int32 scalar)
    delta: jax.Array  # final flip fraction


def _prep(g, balloon: int, threshold):
    """Loop invariants: edge-map gradients + balloon activation mask."""
    from ..ops.numerics import (shift_down, shift_left, shift_right,
                                shift_up)
    dgx = 0.5 * (shift_down(g) - shift_up(g))
    dgy = 0.5 * (shift_right(g) - shift_left(g))
    if balloon:
        mask = (g > threshold / abs(float(balloon))).astype(g.dtype)
    else:
        mask = jnp.zeros_like(g)
    return dgx, dgy, mask


def _init_ls(g, p: CVParams, ls0):
    if ls0 is not None:
        return jnp.asarray(ls0 >= 0.5 if ls0.dtype != bool else ls0,
                           g.dtype)
    return (init_phi(g.shape, p.init, g.dtype) >= 0).astype(g.dtype)


def gac_iteration(ls, dgx, dgy, mask, balloon: int, k, smoothing: int):
    """One full MorphGAC iteration: balloon + attraction + smoothing.

    ``k`` is the traced smoothing-call counter (iteration n starts at
    k = n * smoothing), driving the SIoIS / ISoSI alternation exactly as
    in models/morph.py."""
    ls_new = gac_step(ls, dgx, dgy, mask, balloon)
    return smooth(ls_new, k, smoothing)


@functools.partial(jax.jit, static_argnames=("p", "smoothing", "balloon",
                                             "threshold"))
def segment_gac(g, p: CVParams = CVParams(),
                ls0: Optional[jax.Array] = None,
                smoothing: int = 1,
                balloon: int = 0,
                threshold: float = 0.5) -> GACResult:
    """Segment the edge map g to convergence (flip tol) or p.max_iter.

    Same convergence machinery as segment_morph: mask-flip fraction with
    the 2-cycle minimum (the alternating smoothing's deterministic
    period-2 limit cycles ARE convergence), shared
    patience/min_iter/divergence loop_continue. ``balloon``/``threshold``
    are static (they pick the compiled program); ``g`` should come from
    ops.morph.inverse_gaussian_gradient (values in (0, 1])."""
    ls_init = _init_ls(g, p, ls0)
    b = int(balloon)
    s = int(smoothing)
    dgx, dgy, mask = _prep(g, b, float(threshold))
    # NaN-poison: a non-finite edge map must abort the loop, not freeze
    # the binary state (comparisons against NaN are False, so the flip
    # metric alone would read 0 = "converged"). g is loop-invariant, so
    # the poison reduction happens ONCE, outside the loop body.
    poison = 0.0 * jnp.sum(g)

    def cond(state):
        _, _, n, delta, streak = state
        return loop_continue(n, delta, streak, p)

    def body(state):
        ls, ls_prev, n, _, streak = state
        ls_new = gac_iteration(ls, dgx, dgy, mask, b, n * s, s)
        flips = jnp.mean((ls_new != ls).astype(ls.dtype)) + poison
        flips2 = jnp.mean((ls_new != ls_prev).astype(ls.dtype))
        delta = jnp.minimum(flips, flips2)
        streak = jnp.where(delta < p.tol, streak + 1, 0)
        return (ls_new, ls, n + 1, delta, streak)

    init = (ls_init, ls_init, jnp.int32(0),
            jnp.asarray(jnp.inf, g.dtype), jnp.int32(0))
    ls, _, iters, delta, _ = jax.lax.while_loop(cond, body, init)
    return GACResult(ls, ls >= 0.5, iters, delta)


class GACTrace(NamedTuple):
    ls: jax.Array
    mask: jax.Array
    delta: jax.Array  # (iters,) flip fraction of each iteration


@functools.partial(jax.jit, static_argnames=("p", "iters", "smoothing",
                                             "balloon", "threshold"))
def segment_gac_fixed(g, p: CVParams = CVParams(), iters: int = 100,
                      ls0: Optional[jax.Array] = None,
                      smoothing: int = 1,
                      balloon: int = 0,
                      threshold: float = 0.5,
                      start_iter: int = 0) -> GACTrace:
    """Fixed-iteration MorphGAC with a per-iteration flip trace (scan
    twin; ``start_iter`` offsets the smoothing-call counter so chunked
    runs keep the exact alternation of one long run)."""
    ls_init = _init_ls(g, p, ls0)
    b = int(balloon)
    s = int(smoothing)
    dgx, dgy, mask = _prep(g, b, float(threshold))

    def body(carry, _):
        ls, n = carry
        ls_new = gac_iteration(ls, dgx, dgy, mask, b, n * s, s)
        flips = jnp.mean((ls_new != ls).astype(ls.dtype))
        return (ls_new, n + 1), flips

    (ls, _), ds = jax.lax.scan(
        body, (ls_init, jnp.asarray(start_iter, jnp.int32)), None,
        length=iters)
    return GACTrace(ls, ls >= 0.5, ds)


def segment_gac_sharded(g, p: CVParams = CVParams(), mesh=None,
                        ls0: Optional[jax.Array] = None,
                        smoothing: int = 1,
                        balloon: int = 0,
                        threshold: float = 0.5) -> GACResult:
    """MorphGAC spatially sharded over a 2D ('x', 'y') device mesh.

    Same GSPMD story as segment_morph_sharded (models/morph.py) but even
    more favorable: the GAC loop body has NO global reductions at all -
    every iteration is shifts + elementwise min/max/select - so the
    partitioned program is per-shard compute + depth-1 halo
    collective-permutes only; the single all-reduce-free program scales
    with zero serialization points. The wrapper just pins placements and
    delegates to segment_gac on sharded arrays."""
    from ..parallel.mesh import NamedSharding, P

    if mesh is None:
        raise ValueError("segment_gac_sharded needs a mesh "
                         "(parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = g.shape
    if H % nx or W % ny:
        raise ValueError(f"edge map {H}x{W} not divisible by mesh "
                         f"{nx}x{ny}")
    gs = jax.device_put(g, NamedSharding(mesh, P("x", "y")))
    ls = _init_ls(g, p, ls0)
    lss = jax.device_put(ls, NamedSharding(mesh, P("x", "y")))
    return segment_gac(gs, p, ls0=lss, smoothing=smoothing,
                       balloon=balloon, threshold=threshold)


@functools.partial(jax.jit, static_argnames=("p", "iters", "smoothing",
                                             "balloon", "threshold",
                                             "start_iter"))
def segment_gac_iterations(g, p: CVParams = CVParams(), iters: int = 100,
                           ls0: Optional[jax.Array] = None,
                           smoothing: int = 1,
                           balloon: int = 0,
                           threshold: float = 0.5,
                           start_iter: int = 0) -> GACResult:
    """Lean fixed-iteration MorphGAC: no per-iteration trace.

    The raw-throughput twin of segment_gac_fixed: the loop body is the
    iteration ONLY - balloon select, attraction select, smoothing - with
    not a single reduction anywhere in the program until the final
    (traced) mask. Same trajectory as the other drivers (shared
    gac_iteration; start_iter offsets the alternation counter)."""
    ls_init = _init_ls(g, p, ls0)
    b = int(balloon)
    s = int(smoothing)
    dgx, dgy, mask = _prep(g, b, float(threshold))
    s0 = jnp.asarray(start_iter, jnp.int32)

    def body(n, ls):
        return gac_iteration(ls, dgx, dgy, mask, b, (s0 + n) * s, s)

    ls = jax.lax.fori_loop(0, iters, body, ls_init)
    flips = jnp.asarray(jnp.nan, g.dtype)  # not tracked on this path
    return GACResult(ls, ls >= 0.5, jnp.int32(iters), flips)
