"""Morphological Chan-Vese (MorphACWE) segmentation driver.

L3 driver over ops/morph.py: the published morphological approximation
of the Chan-Vese flow (Marquez-Neila et al., PAMI 2014; the algorithm
scikit-image ships as ``morphological_chan_vese``). Each iteration is

    c_in, c_out = binary region means of the image
    ls          = discrete ACWE force step (sign of the data force at
                  contour pixels)
    ls          = ``smoothing`` alternating SIoIS / ISoSI cycles

on a binary {0,1} level set - pure shift/min/max arithmetic, so the
whole tolerance loop compiles into one device program exactly like the
PDE drivers (models/scalar.py): a ``lax.while_loop`` with the shared
``loop_continue`` predicate, mask-flip convergence, NaN-poison
divergence abort, and a ``lax.scan`` trace twin.

Relative to the PDE family this trades sub-pixel contour placement and
a tunable length penalty (mu) for unconditional stability and a far
cheaper iteration (~10 elementwise passes, no transcendentals, no
linear solve) - the classic use case is fast masks on large images or
as a warm start for the PDE drivers. Works for grayscale (H, W) and
vector-valued (H, W, C) images with per-channel lambda weights, same
conventions as models/vector.py.

The reference mount is empty (SURVEY.md Section 0); this family is a
rebuild-side capability completing the scikit-image compat surface
(compat.morphological_chan_vese mirrors the skimage signature).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.morph import acwe_energy, acwe_step, binary_means, smooth
from ..ops.reductions import loop_continue
from ..params import CVParams
from ..utils.init_phi import init_phi


class MorphResult(NamedTuple):
    ls: jax.Array     # final binary level set (H, W), values {0.0, 1.0}
    mask: jax.Array   # ls >= 0.5 (bool)
    iters: jax.Array  # iterations actually run (int32 scalar)
    delta: jax.Array  # final flip fraction
    c1: jax.Array     # inside mean(s)  (scalar or (C,))
    c2: jax.Array     # outside mean(s)


def _lambdas(u0, p: CVParams, lambda1, lambda2):
    if u0.ndim == 3:
        l1, l2 = p.channel_lambdas(u0.shape[-1], lambda1, lambda2)
        return (jnp.asarray(l1, u0.dtype), jnp.asarray(l2, u0.dtype))
    l1 = p.lambda1 if lambda1 is None else float(lambda1)
    l2 = p.lambda2 if lambda2 is None else float(lambda2)
    return (jnp.asarray(l1, u0.dtype), jnp.asarray(l2, u0.dtype))


def _init_ls(u0, p: CVParams, ls0):
    if ls0 is not None:
        return jnp.asarray(ls0 >= 0.5 if ls0.dtype != bool else ls0,
                           u0.dtype)
    # binary threshold of the framework's named phi inits (checkerboard /
    # circle / rect); the morphological flow only sees the sign pattern
    return (init_phi(u0.shape[:2], p.init, u0.dtype) >= 0).astype(u0.dtype)


def morph_step(ls, u0, l1, l2, k, smoothing: int):
    """One full MorphACWE iteration; returns (ls_new, c_in, c_out, flips).

    ``k`` is the traced smoothing-call counter (iteration n starts at
    k = n * smoothing) driving the SIoIS / ISoSI alternation.
    """
    c_in, c_out = binary_means(u0, ls)
    ls_new = acwe_step(ls, u0, c_in, c_out, l1, l2)
    ls_new = smooth(ls_new, k, smoothing)
    flips = jnp.mean((ls_new != ls).astype(ls.dtype))
    # NaN-poison: a non-finite image/means must abort the loop instead of
    # freezing the binary state and reporting 0 flips as convergence
    flips = flips + 0.0 * (jnp.sum(c_in) + jnp.sum(c_out))
    return ls_new, c_in, c_out, flips


@functools.partial(jax.jit,
                   static_argnames=("p", "smoothing", "lambda1", "lambda2"))
def segment_morph(u0, p: CVParams = CVParams(),
                  ls0: Optional[jax.Array] = None,
                  smoothing: int = 1,
                  lambda1=None, lambda2=None) -> MorphResult:
    """Segment to convergence (flip-fraction tol) or p.max_iter.

    Convergence is ALWAYS the mask-flip fraction here (the level set is
    binary, so 'flips' is the only meaningful update norm; p.conv_norm
    is ignored), with the shared patience/min_iter/divergence machinery
    of loop_continue - EXCEPT that the metric is the MINIMUM of the flip
    fraction vs the previous state and vs the state TWO iterations back.
    The alternating SIoIS/ISoSI smoothing routinely settles into a
    period-2 limit cycle on a few boundary pixels (measured: 2 px of a
    96^2 two-disk image flip forever); the dynamics are deterministic,
    so ls_{n+1} == ls_{n-1} recurs for all time and IS convergence (this
    is why the published scheme runs a fixed iteration count - the
    2-cycle test restores a sound tolerance mode). ``ls0`` (optional) is
    any array whose >=0.5 threshold seeds the level set; otherwise
    p.init names the shape.
    """
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)
    ls_init = _init_ls(u0, p, ls0)
    s = int(smoothing)

    def cond(state):
        _, _, n, delta, streak = state
        return loop_continue(n, delta, streak, p)

    def body(state):
        ls, ls_prev, n, _, streak = state
        ls_new, _, _, flips = morph_step(ls, u0, l1, l2, n * s, s)
        flips2 = jnp.mean((ls_new != ls_prev).astype(ls.dtype))
        delta = jnp.minimum(flips, flips2)
        streak = jnp.where(delta < p.tol, streak + 1, 0)
        return (ls_new, ls, n + 1, delta, streak)

    init = (ls_init, ls_init, jnp.int32(0),
            jnp.asarray(jnp.inf, u0.dtype), jnp.int32(0))
    ls, _, iters, delta, _ = jax.lax.while_loop(cond, body, init)
    c1, c2 = binary_means(u0, ls)
    return MorphResult(ls, ls >= 0.5, iters, delta, c1, c2)


class MorphTrace(NamedTuple):
    ls: jax.Array
    mask: jax.Array
    energy: jax.Array  # (iters,) ACWE data energy after each iteration
    delta: jax.Array   # (iters,) flip fraction of each iteration
    c1: jax.Array      # (iters, ...) means used by each iteration
    c2: jax.Array


@functools.partial(jax.jit, static_argnames=("p", "iters", "smoothing",
                                             "lambda1", "lambda2"))
def segment_morph_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                        ls0: Optional[jax.Array] = None,
                        smoothing: int = 1,
                        lambda1=None, lambda2=None,
                        start_iter: int = 0) -> MorphTrace:
    """Fixed-iteration MorphACWE with a per-iteration trace (scan twin of
    segment_morph, same convention as models/scalar.segment_fixed).
    ``start_iter`` offsets the smoothing-call counter so chunked runs
    keep the exact SIoIS / ISoSI alternation of one long run."""
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)
    ls_init = _init_ls(u0, p, ls0)
    s = int(smoothing)

    def body(carry, _):
        ls, n = carry
        ls_new, c_in, c_out, flips = morph_step(ls, u0, l1, l2, n * s, s)
        c1n, c2n = binary_means(u0, ls_new)
        e = acwe_energy(u0, ls_new, c1n, c2n, l1, l2)
        return (ls_new, n + 1), (e, flips, c_in, c_out)

    (ls, _), (es, ds, c1s, c2s) = jax.lax.scan(
        body, (ls_init, jnp.asarray(start_iter, jnp.int32)), None,
        length=iters)
    return MorphTrace(ls, ls >= 0.5, es, ds, c1s, c2s)


def segment_morph_sharded(u0, p: CVParams = CVParams(), mesh=None,
                          ls0: Optional[jax.Array] = None,
                          smoothing: int = 1,
                          lambda1=None, lambda2=None) -> MorphResult:
    """MorphACWE spatially sharded over a 2D ('x', 'y') device mesh.

    Design note: unlike the PDE family - whose semi-implicit sweeps need
    shard_map, deep halos and replica-rim resync (parallel/sharded.py) -
    the morphological
    iteration is ONLY neighbor shifts (concat/slice) + global mean
    reductions + elementwise min/max. That is exactly the program class
    GSPMD partitions automatically and well: with (x, y)-sharded inputs
    the jitted while_loop compiles to per-shard elementwise work, halo
    collective-permutes for the shifts, and all-reduces for the means -
    the same comm pattern the explicit paths implement by hand, chosen
    here by the compiler. So the sharded driver IS segment_morph on
    sharded arrays; this wrapper just pins the placements (and seeds the
    level set on the host so the loop state starts sharded rather than
    replicated).

    Equivalence to the unsharded driver is exact on the binary state up
    to mean-reduction order (a force-sign tie within one reduction-order
    ulp of zero could in principle flip a pixel; tests pin exactness on
    seeded images). Works for (H, W) and (H, W, C); H % nx == 0 and
    W % ny == 0 are required so shards are uniform.
    """
    from ..parallel.mesh import NamedSharding, P

    if mesh is None:
        raise ValueError("segment_morph_sharded needs a mesh "
                         "(parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = u0.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {H}x{W} not divisible by mesh "
                         f"{nx}x{ny}")
    img_spec = P("x", "y") if u0.ndim == 2 else P("x", "y", None)
    u0s = jax.device_put(u0, NamedSharding(mesh, img_spec))
    ls = _init_ls(u0, p, ls0)
    lss = jax.device_put(ls, NamedSharding(mesh, P("x", "y")))
    return segment_morph(u0s, p, ls0=lss, smoothing=smoothing,
                         lambda1=lambda1, lambda2=lambda2)


@functools.partial(jax.jit, static_argnames=("p", "iters", "smoothing",
                                             "lambda1", "lambda2",
                                             "start_iter"))
def segment_morph_iterations(u0, p: CVParams = CVParams(),
                             iters: int = 100,
                             ls0: Optional[jax.Array] = None,
                             smoothing: int = 1,
                             lambda1=None, lambda2=None,
                             start_iter: int = 0) -> MorphResult:
    """Lean fixed-iteration MorphACWE: no per-iteration trace.

    segment_morph_fixed pays two extra full-array reductions per
    iteration for the energy trace; this fori_loop twin runs only the
    iteration itself (means + force + smoothing) - the raw-throughput
    entry point and the right call when chunk-driving without
    diagnostics. Same trajectory as the other drivers (shared
    morph_step; start_iter offsets the alternation counter exactly like
    segment_morph_fixed).
    """
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)
    ls_init = _init_ls(u0, p, ls0)
    s = int(smoothing)
    s0 = jnp.asarray(start_iter, jnp.int32)

    def body(n, ls):
        ls_new, _, _, _ = morph_step(ls, u0, l1, l2, (s0 + n) * s, s)
        return ls_new

    ls = jax.lax.fori_loop(0, iters, body, ls_init)
    c1, c2 = binary_means(u0, ls)
    flips = jnp.asarray(jnp.nan, u0.dtype)  # not tracked on this path
    return MorphResult(ls, ls >= 0.5, jnp.int32(iters), flips, c1, c2)
