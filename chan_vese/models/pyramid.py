"""Coarse-to-fine (multiscale pyramid) Chan-Vese driver.

Classic multiscale acceleration for level-set segmentation (the published
Chan-Vese lineage routinely uses multiresolution warm starts; the empty
reference mount publishes none - SURVEY.md Section 0 - so this is a
rebuild-side capability on top of the L3 drivers): segment a 2x-decimated
copy of the image first, upsample the converged level set, and use it as
the initialization one level finer. The contour at each finer level only
needs LOCAL refinement (a few pixels around the upsampled interface), so
the expensive full-resolution level runs a handful of iterations instead
of the full from-scratch schedule - on large images the total wall clock
drops by whatever fraction of iterations the warm start saves, while the
fixed point it lands on is the same basin (per-level convergence is the
standard tol/patience machinery of the underlying drivers).

Each level is ONE device program (the tolerance-mode driver of
models/scalar.py), so a pyramid run is L back-to-back device programs
with only the level set handed across - no host work in between beyond
the (jitted) resize. Decimation is exact 2x2 mean pooling
(a reshape-reduce XLA fuses into one pass); level-set upsampling is
bilinear via jax.image.resize with a x2 value scale, preserving the
|grad phi| ~ O(1) magnitude an SDF-like phi carries so the semi-implicit
step's curvature regularization starts at the right scale.

Level planning: ``levels=None`` decimates while both dimensions stay
even and min(H, W) stays >= ``min_dim`` (default 128 - below that the
per-iteration latency floor dominates and extra levels stop paying).

Works for grayscale (H, W) and vector-valued (H, W, C) images via
``segment_pyramid``; the multiphase family (M coupled level sets,
2^M phases) gets the same treatment in ``segment_pyramid_multiphase``
(each phi is independently upsampled + redistanced - the coupling lives
entirely in the per-level solves).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..ops.reinit import reinit as _reinit
from ..params import CVParams
from .scalar import segment


class PyramidResult(NamedTuple):
    phi: jax.Array          # final full-resolution level set (H, W)
    mask: jax.Array         # phi >= 0 (bool)
    iters: jax.Array        # iterations run at the FINEST level (the
                            # full-resolution work; compare to a direct
                            # run's SegResult.iters)
    delta: jax.Array        # finest level's final update norm
    c1: jax.Array           # final inside mean(s)
    c2: jax.Array           # final outside mean(s)
    level_iters: Tuple[int, ...]  # per-level iterations, coarse -> fine


def plan_levels(H: int, W: int, levels: Optional[int] = None,
                min_dim: int = 128) -> int:
    """Number of 2x decimations to use (0 = no pyramid).

    Auto (levels=None): decimate while both dims remain even and
    min(H, W) stays >= min_dim. An explicit ``levels`` is clipped to
    the divisibility limit (odd intermediate dims are never produced).
    """
    max_div = 0
    h, w = H, W
    while h % 2 == 0 and w % 2 == 0 and min(h, w) >= 2 * min_dim:
        h, w = h // 2, w // 2
        max_div += 1
    if levels is None:
        return max_div
    return max(0, min(levels, max_div))


def downsample2x(u0: jax.Array) -> jax.Array:
    """Exact 2x2 mean pooling; (H, W) or (H, W, C), H and W even."""
    H, W = u0.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"downsample2x needs even dims, got {u0.shape}")
    x = u0.reshape((H // 2, 2, W // 2, 2) + u0.shape[2:])
    return x.mean(axis=(1, 3))


def upsample_phi2x(phi: jax.Array) -> jax.Array:
    """Bilinear 2x upsample of a level set, values scaled by 2.

    The value scale keeps an SDF-like phi's gradient magnitude ~1 in the
    finer grid's pixel units (distances double in pixels), so the
    curvature term |grad phi| regularization starts at the scale the
    coarse level converged with. Only the sign matters for the region
    means, so this is a conditioning choice, not a correctness one.
    """
    H, W = phi.shape
    return jax.image.resize(phi, (2 * H, 2 * W), "linear") * 2.0


_pool = jax.jit(downsample2x)
_redistance = jax.jit(_reinit, static_argnums=(1,))


def segment_pyramid(u0, p: CVParams = CVParams(),
                    levels: Optional[int] = None,
                    phi0: Optional[jax.Array] = None,
                    lambda1: Optional[Sequence[float]] = None,
                    lambda2: Optional[Sequence[float]] = None,
                    min_dim: int = 128) -> PyramidResult:
    """Coarse-to-fine segmentation to convergence.

    Each level runs models/scalar.segment in tolerance mode. ``phi0``
    (optional) seeds the COARSEST level (mean-pooled down).
    Per-channel lambda tuples follow the vector-valued convention
    (models/vector.py).
    """
    if u0.ndim == 3:
        lambda1, lambda2 = p.channel_lambdas(u0.shape[-1], lambda1,
                                             lambda2)
    L = plan_levels(*u0.shape[:2], levels=levels, min_dim=min_dim)

    # image pyramid, fine -> coarse (exact mean pooling, jitted)
    images = [u0]
    for _ in range(L):
        images.append(_pool(images[-1]))

    phi = None
    if phi0 is not None:
        phi = phi0
        for _ in range(L):
            # distances halve in the coarser grid's pixel units
            phi = _pool(phi) * 0.5

    level_iters = []
    res = None
    for lvl, u in enumerate(reversed(images)):  # coarse -> fine
        res = segment(u, p, phi0=phi, lambda1=lambda1, lambda2=lambda2)
        level_iters.append(int(res.iters))
        if lvl < L:
            # Redistance the upsampled level set before refining: the
            # converged coarse phi has grown to O(100+) amplitude (the
            # semi-implicit flow's ~t^(1/3) drift, CLAUDE.md invariants),
            # so its near-interface slope is huge and the fine level's
            # data force could barely move the contour - MEASURED to make
            # the warm start a net LOSS (finest level 28 iters vs 18 from
            # scratch at 256^2). With the Sussman redistance the slope is
            # ~1 within the delta_eps band and the finest level only pays
            # for true local refinement.
            phi = _redistance(upsample_phi2x(res.phi), p.reinit_steps)

    return PyramidResult(res.phi, res.mask, res.iters, res.delta,
                         res.c1, res.c2, tuple(level_iters))


class MultiphasePyramidResult(NamedTuple):
    phis: jax.Array      # (M, H, W) final full-resolution level sets
    labels: jax.Array    # (H, W) int32 phase labels (bit m = phi_m >= 0)
    iters: jax.Array     # iterations run at the FINEST level
    delta: jax.Array     # finest level's final label-flip fraction
    cs: jax.Array        # (2^M, ...) phase means
    level_iters: Tuple[int, ...]  # per-level iterations, coarse -> fine


def segment_pyramid_multiphase(u0, p: CVParams = CVParams(),
                               m_sets: int = 2,
                               levels: Optional[int] = None,
                               phis0: Optional[jax.Array] = None,
                               min_dim: int = 128
                               ) -> MultiphasePyramidResult:
    """Coarse-to-fine multiphase (Vese-Chan) segmentation to convergence.

    Same structure as segment_pyramid, with models/multiphase's
    segment_multiphase as the per-level solver. The M level sets are
    coupled only through the per-level solves; across levels each phi
    is upsampled and redistanced independently, which preserves the phase-label assignment (labels are
    sign patterns, and bilinear upsampling preserves signs away from the
    interface). ``phis0`` (optional, (M, H, W) at full resolution) seeds
    the coarsest level, mirroring segment_pyramid's phi0.
    """
    from .multiphase import segment_multiphase

    L = plan_levels(*u0.shape[:2], levels=levels, min_dim=min_dim)

    images = [u0]
    for _ in range(L):
        images.append(_pool(images[-1]))

    phis = None
    if phis0 is not None:
        phis = phis0
        for _ in range(L):
            phis = jax.vmap(downsample2x)(phis) * 0.5

    level_iters = []
    res = None
    for lvl, u in enumerate(reversed(images)):  # coarse -> fine
        res = segment_multiphase(u, p, m_sets=m_sets, phis0=phis)
        level_iters.append(int(res.iters))
        if lvl < L:
            # same redistance rationale as the scalar driver above: the
            # converged coarse phis carry O(100+) amplitudes whose steep
            # near-interface slopes would freeze the fine-level contours
            phis = jnp.stack([
                _redistance(upsample_phi2x(res.phis[m]), p.reinit_steps)
                for m in range(m_sets)])

    return MultiphasePyramidResult(res.phis, res.labels, res.iters,
                                   res.delta, res.cs, tuple(level_iters))


def plan_levels_sharded(H: int, W: int, nx: int, ny: int,
                        levels: Optional[int] = None, min_dim: int = 128,
                        comm_k: int = 1, halo: str = "ppermute") -> int:
    """plan_levels with the sharded drivers' coarsest-level constraints.

    Every level must keep H % nx == 0 and W % ny == 0, shards deep
    enough for comm_k's 4k halos, and >= 16x16 under halo='overlap'.
    All constraints are monotone in level size (finer levels have
    strictly larger, equally divisible dims), so only the coarsest
    level needs checking - L is walked down until it satisfies them.
    """
    L = plan_levels(H, W, levels=levels, min_dim=min_dim)

    def ok(h, w):
        if h % nx or w % ny:
            return False
        sh, sw = h // nx, w // ny
        if comm_k > 1 and 4 * comm_k > min(sh, sw):
            return False
        if halo == "overlap" and min(sh, sw) < 16:
            return False
        return True

    while L > 0 and not ok(H >> L, W >> L):
        L -= 1
    return L


def segment_pyramid_sharded(u0, p: CVParams = CVParams(), mesh=None,
                            levels: Optional[int] = None,
                            phi0: Optional[jax.Array] = None,
                            lambda1: Optional[Sequence[float]] = None,
                            lambda2: Optional[Sequence[float]] = None,
                            min_dim: int = 128,
                            halo: str = "ppermute",
                            comm_k: int = 1) -> PyramidResult:
    """Coarse-to-fine segmentation sharded over a 2D device mesh.

    Each level is one parallel/sharded.segment_sharded tolerance-mode
    solve on the SAME mesh (the coarse levels are small, but staying on
    the mesh avoids any host gather of multi-chip-sized arrays); the
    between-level resample/redistance ops are plain jnp on the global
    sharded arrays, partitioned by GSPMD. Level planning adds the
    sharded constraints (divisibility by the mesh, comm_k halo depth,
    overlap rim minimum) - see plan_levels_sharded.
    """
    from ..parallel.sharded import segment_sharded

    if mesh is None:
        raise ValueError("segment_pyramid_sharded needs a mesh "
                         "(parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    L = plan_levels_sharded(*u0.shape[:2], nx, ny, levels=levels,
                            min_dim=min_dim, comm_k=comm_k, halo=halo)
    if u0.ndim == 3:
        lambda1, lambda2 = p.channel_lambdas(u0.shape[-1], lambda1,
                                             lambda2)

    images = [u0]
    for _ in range(L):
        images.append(_pool(images[-1]))

    phi = None
    if phi0 is not None:
        phi = phi0
        for _ in range(L):
            phi = _pool(phi) * 0.5

    level_iters = []
    res = None
    for lvl, u in enumerate(reversed(images)):  # coarse -> fine
        res = segment_sharded(u, p, mesh, phi0=phi, lambda1=lambda1,
                              lambda2=lambda2, halo=halo, comm_k=comm_k)
        level_iters.append(int(res.iters))
        if lvl < L:
            phi = _redistance(upsample_phi2x(res.phi), p.reinit_steps)

    return PyramidResult(res.phi, res.mask, res.iters, res.delta,
                         res.c1, res.c2, tuple(level_iters))


# ---------------------------------------------------------------------------
# pyramid x morphological family (binary level sets)
# ---------------------------------------------------------------------------

class MorphPyramidResult(NamedTuple):
    ls: jax.Array       # final full-resolution binary level set
    mask: jax.Array     # ls >= 0.5 (bool)
    iters: jax.Array    # iterations run at the FINEST level
    delta: jax.Array    # finest level's final (chunk) flip fraction
    level_iters: Tuple[int, ...]  # per-level iterations, coarse -> fine


def upsample_ls2x(ls: jax.Array) -> jax.Array:
    """Nearest-neighbor 2x upsample of a BINARY level set (each coarse
    cell becomes a 2x2 block). No redistance needed - the morphological
    state carries no amplitude, only the sign pattern."""
    return jnp.repeat(jnp.repeat(ls, 2, axis=0), 2, axis=1)


_up_ls = jax.jit(upsample_ls2x)


def segment_pyramid_morph(u0, p: CVParams = CVParams(),
                          levels: Optional[int] = None,
                          ls0: Optional[jax.Array] = None,
                          smoothing: int = 1,
                          lambda1=None, lambda2=None,
                          min_dim: int = 128) -> MorphPyramidResult:
    """Coarse-to-fine MorphACWE to convergence.

    The basin-rescue/contour-travel argument of the PDE pyramid applies
    identically to binary level sets: the discrete force only flips
    pixels WITH a nonzero level-set gradient, so a contour travels at
    most ~1 px per iteration and a from-scratch fine run pays
    O(distance) iterations;
    the coarse levels cover that distance at 1/4, 1/16, ... the pixels.
    Across levels the binary state needs only a nearest-neighbor 2x
    blow-up (upsample_ls2x) - no redistance, there is no amplitude.

    Each level runs models/morph.segment_morph (tolerance mode with the
    2-cycle limit detector). ``ls0`` (optional) seeds the COARSEST
    level (mean-pooled, >= 0.5 threshold per level).
    """
    from .morph import segment_morph

    L = plan_levels(*u0.shape[:2], levels=levels, min_dim=min_dim)

    images = [u0]
    for _ in range(L):
        images.append(_pool(images[-1]))

    ls = None
    if ls0 is not None:
        ls = jnp.asarray(ls0 >= 0.5 if ls0.dtype != bool else ls0,
                         u0.dtype)
        for _ in range(L):
            ls = (_pool(ls) >= 0.5).astype(u0.dtype)

    level_iters = []
    res = None
    for lvl, u in enumerate(reversed(images)):  # coarse -> fine
        res = segment_morph(u, p, ls0=ls, smoothing=smoothing,
                            lambda1=lambda1, lambda2=lambda2)
        level_iters.append(int(res.iters))
        if lvl < L:
            ls = _up_ls(res.ls)

    return MorphPyramidResult(res.ls, res.mask, res.iters, res.delta,
                              tuple(level_iters))


def segment_pyramid_gac(u0, p: CVParams = CVParams(),
                        levels: Optional[int] = None,
                        ls0: Optional[jax.Array] = None,
                        smoothing: int = 1,
                        balloon: int = 0,
                        threshold: float = 0.5,
                        gac_alpha: float = 5.0,
                        gac_sigma: float = 3.0,
                        min_dim: int = 128) -> MorphPyramidResult:
    """Coarse-to-fine MorphGAC to convergence.

    Takes the RAW image (not a precomputed edge map): the
    inverse_gaussian_gradient edge map is recomputed per level from the
    mean-pooled image with the SAME alpha/sigma - pooling halves feature
    sizes in pixels while the blur scale stays fixed, so coarse levels
    see proportionally smoother edge basins (exactly the coarse-to-fine
    effect wanted; pooling a full-resolution g instead would blur the
    very edge minima the attraction needs). The balloon composes
    naturally with the warm start: a warm-started contour sits where
    g < threshold, so the balloon is inactive there and only the
    attraction refines it.

    ``threshold`` may be the float threshold (applied at every level) -
    the compat-style 'auto' percentile should be resolved by the caller
    (cli.py does, from the finest-level edge map).
    """
    from ..ops.morph import inverse_gaussian_gradient
    from .morph_gac import segment_gac

    L = plan_levels(*u0.shape[:2], levels=levels, min_dim=min_dim)

    images = [u0]
    for _ in range(L):
        images.append(_pool(images[-1]))

    ls = None
    if ls0 is not None:
        ls = jnp.asarray(ls0 >= 0.5 if ls0.dtype != bool else ls0,
                         u0.dtype)
        for _ in range(L):
            ls = (_pool(ls) >= 0.5).astype(u0.dtype)

    level_iters = []
    res = None
    for lvl, u in enumerate(reversed(images)):  # coarse -> fine
        g = inverse_gaussian_gradient(u, gac_alpha, gac_sigma)
        res = segment_gac(g, p, ls0=ls, smoothing=smoothing,
                          balloon=balloon, threshold=threshold)
        level_iters.append(int(res.iters))
        if lvl < L:
            ls = _up_ls(res.ls)

    return MorphPyramidResult(res.ls, res.mask, res.iters, res.delta,
                              tuple(level_iters))
