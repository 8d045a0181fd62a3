"""Spatially-sharded Chan-Vese: one big image across a 2D device mesh
(SURVEY.md §3.4, eval config 4: 4K image, 2D-sharded grid + halos).

Structure per iteration, entirely on device inside `jax.shard_map`:

    exchange depth-4 halos of phi (ppermute N/S then E/W; corners ride
      along)                                            <- collective
    red half-sweep on the padded block (halo ring recomputed
      redundantly, so red->black needs no second exchange)
    resync the global-edge replica halos from the red result
    black half-sweep on the block interior
    local partial sums -> psum for c1/c2 and the convergence metric
                                                        <- collective

The loop is a device-side while_loop; control crosses host->device once.

Correctness notes (the subtle bits, covered by the bitwise-vs-unsharded
tests in tests/test_sharded.py):
  * Halo depth 4 covers the composed stencil reach: black at cell x reads
    the red field within [-2, +1] rows/cols, and red at q reads old phi
    within [-2, +1] - total [-4, +2] in each axis (the backward face
    coefficients reach one extra cell up/left).
  * Red/black parity is GLOBAL: masks derive from ix*h + local coords.
  * Global-boundary devices fill halos with edge replicates (clamped-index
    Neumann). Between the half-sweeps those replicas must be REFRESHED
    from the red-updated edge cells: a black boundary cell reads its
    off-grid neighbor as clamp -> its own row/col, which the red pass may
    just have updated. (Without the resync, the replica of an updated red
    edge cell would still hold its pre-sweep value.)
"""

from __future__ import annotations

import functools
import math

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.numerics import heaviside
from ..ops.reductions import loop_continue, means_from_sums
from ..ops.sweep import _update_all
from ..params import CVParams
from ..models.scalar import SegResult
from .halo import exchange_halo2d

_D = 4  # halo depth

def _delta_from_partials(parts, n_pixels, p: CVParams, offset: int = 0):
    """Decode the convergence metric from psum'd partials.

    Layout: [s_uH x C, s_H, s_dphi2, flips, s_absdphi] with ``offset`` =
    C - 1 extra leading channel slots (0 for grayscale).
    """
    if p.conv_norm == "flips":
        # 0 * s_dphi2 NaN-poisons the metric when phi went non-finite
        # (sign comparisons alone would count 0 flips on a NaN field)
        return parts[offset + 3] / n_pixels + 0.0 * parts[offset + 2]
    if p.conv_norm == "rms":
        return jnp.sqrt(parts[offset + 2] / n_pixels)
    if p.conv_norm == "mean_abs":
        return parts[offset + 4] / n_pixels
    raise ValueError(f"unknown conv_norm {p.conv_norm!r}")


def _fold_scalar_lambdas(p: CVParams, lambda1, lambda2) -> CVParams:
    """Grayscale path: lambda overrides fold into the (static) params the
    solver bakes in; per-channel tuples are a vector-image concept."""
    kw = {}
    if lambda1 is not None:
        if np.ndim(lambda1) > 0 and len(np.atleast_1d(lambda1)) > 1:
            raise ValueError("per-channel lambda1 needs an (H, W, C) image")
        kw["lambda1"] = float(np.atleast_1d(lambda1)[0])
    if lambda2 is not None:
        if np.ndim(lambda2) > 0 and len(np.atleast_1d(lambda2)) > 1:
            raise ValueError("per-channel lambda2 needs an (H, W, C) image")
        kw["lambda2"] = float(np.atleast_1d(lambda2)[0])
    return p.replace(**kw) if kw else p


def _global_coords(shape, ix, iy, h, w, pad=_D):
    """(g_i, g_j) int32 grids for a block padded by ``pad`` on each side."""
    pi = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    pj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return ix * h + pi - pad, iy * w + pj - pad


def _resync_replicas(pad, ix, iy, nx, ny, edges=(True, True, True, True),
                     depth=_D):
    """Refresh global-edge replica halos from the current edge cells.

    ``edges`` (static top/bottom/left/right booleans) restricts which
    sides are treated as potential canvas edges - strip slices of the
    canvas (the halo-overlap path) only contain some of them. ``depth``
    is the halo depth of the padded block (4 for the per-iteration
    exchange; 4k for the communication-avoiding chunked path)."""
    et, eb, el, er = edges
    rows = jax.lax.broadcasted_iota(jnp.int32, pad.shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, pad.shape, 1)
    if et:
        top = jnp.broadcast_to(pad[depth: depth + 1, :], pad.shape)
        pad = jnp.where((ix == 0) & (rows < depth), top, pad)
    if eb:
        bot = jnp.broadcast_to(pad[-depth - 1: -depth, :], pad.shape)
        pad = jnp.where((ix == nx - 1) & (rows >= pad.shape[0] - depth),
                        bot, pad)
    if el:
        left = jnp.broadcast_to(pad[:, depth: depth + 1], pad.shape)
        pad = jnp.where((iy == 0) & (cols < depth), left, pad)
    if er:
        right = jnp.broadcast_to(pad[:, -depth - 1: -depth], pad.shape)
        pad = jnp.where((iy == ny - 1) & (cols >= pad.shape[1] - depth),
                        right, pad)
    return pad


def _local_checkerboard(shape, ix, iy, h, w, dtype, period=5.0):
    gi, gj = _global_coords(shape, ix, iy, h, w, pad=0)
    k = math.pi / period
    return (jnp.sin(gi.astype(dtype) * k) * jnp.sin(gj.astype(dtype) * k))


def _local_circle(shape, ix, iy, h, w, H, W, dtype, r=None):
    gi, gj = _global_coords(shape, ix, iy, h, w, pad=0)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    r = min(H, W) / 4.0 if r is None else r
    gi = gi.astype(dtype)
    gj = gj.astype(dtype)
    return r - jnp.sqrt((gi - cy) ** 2 + (gj - cx) ** 2)


def _local_rect(shape, ix, iy, h, w, H, W, dtype, margin=None):
    """Sharded mirror of utils/init_phi.rect (global-coordinate SDF)."""
    gi, gj = _global_coords(shape, ix, iy, h, w, pad=0)
    m = min(H, W) / 8.0 if margin is None else margin
    gi = gi.astype(dtype)
    gj = gj.astype(dtype)
    return jnp.minimum(jnp.minimum(gi - m, (H - 1 - m) - gi),
                       jnp.minimum(gj - m, (W - 1 - m) - gj))


def _sharded_iteration(phi, u0_pad, c1, c2, p: CVParams, ix, iy, nx, ny,
                       h, w, n_pix, sum_u, halo="ppermute"):
    """One red-black iteration on a local block; returns new phi + stats.

    ``halo`` selects the exchange schedule: 'ppermute' (exchange, then
    sweep) or 'overlap' (interior sweep concurrent with the exchange,
    then a rim stitch - _overlap_new).
    """
    if halo == "overlap":
        new = _overlap_new(phi, u0_pad, c1, c2, p, ix, iy, nx, ny, h, w)
    else:
        pad = exchange_halo2d(phi, _D)
        gi, gj = _global_coords(pad.shape, ix, iy, h, w)
        valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
        red = ((gi + gj) % 2 == 0) & valid
        black = ((gi + gj) % 2 == 1) & valid

        f = (-p.nu - p.lambda1 * (u0_pad - c1) ** 2
             + p.lambda2 * (u0_pad - c2) ** 2)

        pad = _sweep_local(pad, f, p, red, black, ix, iy, nx, ny)
        new = pad[_D: _D + h, _D: _D + w]
    # psum'd global reductions
    h_eps = heaviside(new, p.eps)
    u0_loc = u0_pad[_D: _D + h, _D: _D + w]
    dphi = new - phi
    flips = ((new >= 0) != (phi >= 0)).astype(phi.dtype)
    parts = jnp.stack([
        jnp.sum(u0_loc * h_eps), jnp.sum(h_eps),
        jnp.sum(dphi * dphi), jnp.sum(flips), jnp.sum(jnp.abs(dphi)),
    ])
    parts = lax.psum(parts, ("x", "y"))
    c1n, c2n = means_from_sums(parts[0], parts[1], sum_u, n_pix)
    delta = _delta_from_partials(parts, n_pix, p)
    return new, c1n, c2n, delta


def _overlap_new(phi, u0_pad, c1, c2, p: CVParams, ix, iy, nx, ny, h, w):
    """One jnp iteration with halo-comm / interior-compute overlap (the
    PP-analog row of SURVEY.md 2.9).

    Dependency structure: the ppermute halo exchange reads only phi's
    boundary strips while the block INTERIOR updates from purely local
    data (a full red-black iteration at local cell (r, c) has composite
    stencil reach 4 up/left, 2 down/right, so rows [4, h-2) x cols
    [4, w-2) never touch a halo). The two are data-independent, letting
    XLA's async collective-permute run the transfers concurrently
    with the interior sweep. Afterwards four thin strips (16 canvas
    rows/cols) recompute the rim from the exchanged pad - sliced from
    the same masks/data term, with replica resync gated to the canvas
    edges each strip actually contains - and overwrite the rim of the
    interior result. Elementwise identical to the exchange-then-sweep
    path (tests/test_sharded_overlap.py).
    """
    gi, gj = _global_coords((h + 2 * _D, w + 2 * _D), ix, iy, h, w)
    valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
    red = ((gi + gj) % 2 == 0) & valid
    black = ((gi + gj) % 2 == 1) & valid
    f = (-p.nu - p.lambda1 * (u0_pad - c1) ** 2
         + p.lambda2 * (u0_pad - c2) ** 2)

    # interior: purely local (edge-replicated pad carries NO neighbor
    # data; cells within reach of the block edge are overwritten below)
    local_pad = jnp.pad(phi, _D, mode="edge")
    upd_local = _sweep_local(local_pad, f, p, red, black, ix, iy, nx, ny)
    new = upd_local[_D: _D + h, _D: _D + w]

    # communication, independent of the interior compute above
    pad = exchange_halo2d(phi, _D)
    return _overlap_stitch(new, pad, f, p, red, black, ix, iy, nx, ny,
                           h, w)


def _overlap_stitch(new, pad, f, p, red, black, ix, iy, nx, ny, h, w):
    """Overwrite the rim of an interior-only result with strips
    recomputed from the exchanged pad (the stitch half of the overlap
    scheme; rim thickness = composite stencil reach, 4 up/left and 2
    down/right)."""
    S = 16
    ph, pw = h + 2 * _D, w + 2 * _D

    def strip(rs, re, cs, ce, edges):
        return _sweep_local(pad[rs:re, cs:ce], f[rs:re, cs:ce], p,
                            red[rs:re, cs:ce], black[rs:re, cs:ce],
                            ix, iy, nx, ny, resync_edges=edges)

    n_s = strip(0, S, 0, pw, (True, False, True, True))
    s_s = strip(ph - S, ph, 0, pw, (False, True, True, True))
    w_s = strip(0, ph, 0, S, (True, True, True, False))
    e_s = strip(0, ph, pw - S, pw, (True, True, False, True))

    new = new.at[0:_D, :].set(n_s[_D: 2 * _D, _D: _D + w])
    new = new.at[h - 2: h, :].set(
        s_s[S - _D - 2: S - _D, _D: _D + w])
    new = new.at[:, 0:_D].set(w_s[_D: _D + h, _D: 2 * _D])
    new = new.at[:, w - 2: w].set(
        e_s[_D: _D + h, S - _D - 2: S - _D])
    return new


def _sharded_iteration_vec(phi, u0_pad, c1, c2, p, l1, l2, ix, iy, nx, ny,
                           h, w, n_pix, sum_u):
    """Vector-valued (C-channel) jnp sharded iteration (SURVEY.md C9 on
    the 2D mesh): shared phi, per-channel means, channel-averaged
    weighted data term."""
    pad = exchange_halo2d(phi, _D)
    gi, gj = _global_coords(pad.shape, ix, iy, h, w)
    valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
    red = ((gi + gj) % 2 == 0) & valid
    black = ((gi + gj) % 2 == 1) & valid

    l1 = jnp.asarray(l1, phi.dtype)
    l2 = jnp.asarray(l2, phi.dtype)
    f = (-p.nu - jnp.mean(l1 * (u0_pad - c1) ** 2, axis=-1)
         + jnp.mean(l2 * (u0_pad - c2) ** 2, axis=-1))

    pad = _sweep_local(pad, f, p, red, black, ix, iy, nx, ny)

    new = pad[_D: _D + h, _D: _D + w]
    h_eps = heaviside(new, p.eps)
    u0_loc = u0_pad[_D: _D + h, _D: _D + w]
    dphi = new - phi
    flips = ((new >= 0) != (phi >= 0)).astype(phi.dtype)
    c = u0_loc.shape[-1]
    parts = jnp.concatenate([
        jnp.sum(u0_loc * h_eps[..., None], axis=(0, 1)),
        jnp.stack([jnp.sum(h_eps), jnp.sum(dphi * dphi), jnp.sum(flips),
                   jnp.sum(jnp.abs(dphi))]),
    ])
    parts = lax.psum(parts, ("x", "y"))
    c1n, c2n = means_from_sums(parts[:c], parts[c], sum_u, n_pix)
    delta = _delta_from_partials(parts, n_pix, p, offset=c - 1)
    return new, c1n, c2n, delta



def _sharded_energy(new, u0_loc, c1, c2, p: CVParams, lambdas=None):
    """psum'd Chan-Vese energy of a local block, exactly matching
    ops/reductions.energy on the assembled image: forward differences
    read the south/east neighbor through a 1-deep halo, and the halo's
    global-edge replicas make the clamped-difference-vanishes convention
    hold at the true image boundary."""
    from ..ops.numerics import dirac

    pad1 = exchange_halo2d(new, 1)
    ph = pad1[1:-1, 1:-1]
    gx = pad1[2:, 1:-1] - ph
    gy = pad1[1:-1, 2:] - ph
    h = heaviside(new, p.eps)
    length = jnp.sum(dirac(new, p.eps) * jnp.sqrt(gx * gx + gy * gy))
    area = jnp.sum(h)
    if u0_loc.ndim == 3:
        l1, l2 = lambdas
        l1 = jnp.asarray(l1, u0_loc.dtype)
        l2 = jnp.asarray(l2, u0_loc.dtype)
        fit1 = jnp.sum(jnp.mean(l1 * (u0_loc - c1) ** 2, axis=-1) * h)
        fit2 = jnp.sum(jnp.mean(l2 * (u0_loc - c2) ** 2, axis=-1)
                       * (1.0 - h))
        local = p.mu * length + p.nu * area + fit1 + fit2
    else:
        fit1 = jnp.sum((u0_loc - c1) ** 2 * h)
        fit2 = jnp.sum((u0_loc - c2) ** 2 * (1.0 - h))
        local = (p.mu * length + p.nu * area
                 + p.lambda1 * fit1 + p.lambda2 * fit2)
    return lax.psum(local, ("x", "y"))


def _sharded_reinit(phi_local, n, p: CVParams, always=False):
    """Halo-aware redistancing on a local block (no-op when disabled).

    The Godunov upwind stencil propagates one cell per step, so a single
    halo exchange of depth = reinit_steps makes the padded redistance
    EXACTLY the unsharded one on the block interior (edge replicas at
    global boundaries equal the clamped-shift semantics of ops/reinit.py).
    ``always=True`` skips the cadence cond (the caller already branched).
    """
    if not p.reinit_every:
        return phi_local
    from ..ops.reinit import reinit

    depth = p.reinit_steps

    def do(x):
        pad = exchange_halo2d(x, depth)
        out = reinit(pad, p.reinit_steps)
        return out[depth: depth + x.shape[0], depth: depth + x.shape[1]]

    if always:
        return do(phi_local)
    return jax.lax.cond((n + 1) % p.reinit_every == 0, do,
                        lambda v: v, phi_local)


def _sweep_local(pad, f, p, red, black, ix, iy, nx, ny,
                 resync_edges=(True, True, True, True), depth=_D):
    """Red+black half-sweeps on a padded block with replica resync."""
    upd = _update_all(pad, f, p.mu, p.dt, p.eps, p.eta2)
    pad = jnp.where(red, upd, pad)
    pad = _resync_replicas(pad, ix, iy, nx, ny, resync_edges, depth)
    upd = _update_all(pad, f, p.mu, p.dt, p.eps, p.eta2)
    return jnp.where(black, upd, pad)


def _sharded_phase_means(u0_loc, phis, p: CVParams):
    """psum'd 2^M phase means of the local blocks (per-channel for RGB)."""
    m_sets = phis.shape[0]
    vec = u0_loc.ndim == 3
    hs = [heaviside(phis[m], p.eps) for m in range(m_sets)]
    cs = []
    for sbit in range(2 ** m_sets):
        wgt = None
        for m in range(m_sets):
            factor = hs[m] if (sbit >> m) & 1 else (1.0 - hs[m])
            wgt = factor if wgt is None else wgt * factor
        if vec:
            num = lax.psum(jnp.sum(u0_loc * wgt[..., None], axis=(0, 1)),
                           ("x", "y"))
        else:
            num = lax.psum(jnp.sum(u0_loc * wgt), ("x", "y"))
        den = lax.psum(jnp.sum(wgt), ("x", "y"))
        cs.append(num / jnp.maximum(den, 1e-30))
    return cs


def _sharded_multiphase_m_overlap(new, u0_pad, cs, p: CVParams, m, m_sets,
                                  ix, iy, nx, ny, h, w):
    """Level set ``m``'s update with halo-comm / interior-compute overlap
    (the multiphase twin of _overlap_new; SURVEY.md 2.9 PP row x C10).

    The block INTERIOR of phi_m's coupled sweep depends only on owned
    data: the composite red-black stencil reaches 4 up/left / 2
    down/right, and the coupling term consumes the other level sets'
    Heavisides pointwise, so interior cells never read a halo of ANY
    level set. The exchanges of all M level sets are therefore
    data-independent of an interior sweep computed from locally
    edge-padded copies, and XLA can run the ppermutes concurrently with
    it. The rim is then overwritten with strips recomputed from the
    exchanged pads via the shared _overlap_stitch - elementwise
    identical to the exchange-then-sweep path
    (tests/test_sharded_multiphase.py).
    """
    def hside(x):
        return heaviside(x, p.eps)

    gi, gj = _global_coords((h + 2 * _D, w + 2 * _D), ix, iy, h, w)
    valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
    red = ((gi + gj) % 2 == 0) & valid
    black = ((gi + gj) % 2 == 1) & valid

    # interior: purely local (edge-replicated pads carry NO neighbor
    # data; rim cells within reach of the block edge are overwritten)
    lpads = [jnp.pad(new[k], _D, mode="edge") for k in range(m_sets)]
    f_loc = _mp_coupling_f([hside(lp) for lp in lpads], u0_pad, cs, p,
                           m, m_sets, new.dtype)
    upd = _sweep_local(lpads[m], f_loc, p, red, black, ix, iy, nx, ny)
    nm = upd[_D: _D + h, _D: _D + w]

    # communication, independent of the interior compute above
    pads = [exchange_halo2d(new[k], _D) for k in range(m_sets)]
    f_pad = _mp_coupling_f([hside(pd) for pd in pads], u0_pad, cs, p,
                           m, m_sets, new.dtype)
    return _overlap_stitch(nm, pads[m], f_pad, p, red, black, ix, iy,
                           nx, ny, h, w)


def _mp_coupling_f(hs_pad, u0_pad, cs, p: CVParams, m, m_sets, dtype):
    """Vese-Chan coupling data term for level set ``m`` on a padded
    block: sum over the 2^M phase labels of +-sqdist(u0, c_label)
    weighted by the OTHER level sets' Heaviside products (hs_pad),
    minus nu. Shared by the exchange-then-sweep and overlap multiphase
    iterations (the latter evaluates it twice: once from local pads for
    the interior, once from exchanged pads for the rim strips)."""
    vec = u0_pad.ndim == 3

    def sqdist(upad, c):
        if vec:
            return jnp.mean((upad - c) ** 2, axis=-1)
        return (upad - c) ** 2

    f = jnp.zeros(u0_pad.shape[:2], dtype=dtype)
    for sbit in range(2 ** m_sets):
        d = sqdist(u0_pad, cs[sbit])
        w_other = None
        for k in range(m_sets):
            if k == m:
                continue
            factor = hs_pad[k] if (sbit >> k) & 1 else (1.0 - hs_pad[k])
            w_other = factor if w_other is None else w_other * factor
        if w_other is None:
            w_other = jnp.ones_like(f)
        sign = -1.0 if (sbit >> m) & 1 else 1.0
        f = f + sign * d * w_other
    return f - p.nu


def _sharded_multiphase_iteration(phis, u0_pad, p: CVParams, ix, iy, nx, ny,
                                  h, w, n_pix, halo="ppermute"):
    """One multiphase (M coupled level sets) iteration on a local block.

    Mirrors models/multiphase.py: 2^M psum'd phase means once per
    iteration, then M sequential padded red-black sweeps (each with its
    own halo exchange - phi_m's sweep sees phi_{m-1}'s update). Handles
    grayscale (h, w) and vector-valued (h, w, C) u0_pad (per-channel
    phase means, channel-averaged squared distances). ``halo`` selects
    the per-level-set exchange schedule (ppermute, or overlap - the
    latter computes the block interior from purely local data while
    the exchanges fly, then stitches the rim; see
    _sharded_multiphase_m_overlap).
    """
    m_sets = phis.shape[0]
    u0_loc = u0_pad[_D: _D + h, _D: _D + w]

    def hside(x):
        return heaviside(x, p.eps)

    # 2^M phase means (psum'd masked reductions; per-channel for RGB)
    cs = _sharded_phase_means(u0_loc, phis, p)

    new = phis
    for m in range(m_sets):
        if halo == "overlap":
            nm = _sharded_multiphase_m_overlap(new, u0_pad, cs, p, m,
                                               m_sets, ix, iy, nx, ny,
                                               h, w)
            new = new.at[m].set(nm)
            continue
        pad = exchange_halo2d(new[m], _D)
        gi, gj = _global_coords(pad.shape, ix, iy, h, w)
        valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
        red = ((gi + gj) % 2 == 0) & valid
        black = ((gi + gj) % 2 == 1) & valid
        # coupling term from the padded CURRENT level sets (reuse the
        # sweep's own exchange for level set m)
        hs_pad = [hside(pad) if k == m else
                  hside(exchange_halo2d(new[k], _D))
                  for k in range(m_sets)]
        f = _mp_coupling_f(hs_pad, u0_pad, cs, p, m, m_sets, phis.dtype)
        upd = _sweep_local(pad, f, p, red, black, ix, iy, nx, ny)
        new = new.at[m].set(upd[_D: _D + h, _D: _D + w])

    # label-flip convergence metric
    def labels(ph):
        lab = jnp.zeros(ph.shape[1:], jnp.int32)
        for m in range(m_sets):
            lab = lab | ((ph[m] >= 0).astype(jnp.int32) << m)
        return lab

    flips = lax.psum(
        jnp.sum((labels(new) != labels(phis)).astype(phis.dtype))
        + 0.0 * jnp.sum(new),  # NaN-poison: divergence detection
        ("x", "y"))
    return new, flips / n_pix



def _sharded_chunk_jnp(phi, u0_padk, c1, c2, p: CVParams, k, ix, iy,
                       nx, ny, h, w, n_pix, sum_u):
    """Communication-avoiding chunk: ONE depth-4k halo exchange, then k
    frozen-means red-black iterations on the padded block (SURVEY.md
    §2.9 scale-out).

    Per iteration the exact-trajectory region of the pad shrinks by the
    composite stencil reach (4 up/left, 2 down/right), so a 4k-deep halo
    keeps the owned block exact through all k iterations (overlapped
    tiling, with the halo as the deep rim). Communication VOLUME per
    iteration is ~2x the depth-4-every-iteration path (4k-deep halos
    every k iterations, both directions), but the collective LATENCY -
    ppermute rounds and the means psum - drops k-fold, which is the
    regime that matters on big meshes. c1/c2 are frozen across the
    chunk (refreshed from the chunk's final partials): the
    frozen-means-per-chunk trajectory class, k = 1 degenerating to the
    standard per-iteration path.

    The halo depth comes from ``u0_padk`` (4 * comm_k), not from ``k``:
    the static remainder chunk runs fewer iterations against the same
    loop-invariant padded image.
    """
    D = (u0_padk.shape[0] - h) // 2
    pad = exchange_halo2d(phi, D)
    gi, gj = _global_coords(pad.shape, ix, iy, h, w, pad=D)
    valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
    red = ((gi + gj) % 2 == 0) & valid
    black = ((gi + gj) % 2 == 1) & valid
    f = (-p.nu - p.lambda1 * (u0_padk - c1) ** 2
         + p.lambda2 * (u0_padk - c2) ** 2)

    prev = pad
    for _ in range(k):
        prev = pad
        # refresh the global-edge Neumann replicas from the CURRENT edge
        # cells: the sweeps never touch invalid (out-of-globe) halo
        # cells, and the per-iteration-exchange path rebuilds them from
        # the post-iteration state every exchange (no-op at j = 0, where
        # exchange_halo2d just installed them)
        pad = _resync_replicas(pad, ix, iy, nx, ny, depth=D)
        pad = _sweep_local(pad, f, p, red, black, ix, iy, nx, ny, depth=D)

    new = pad[D: D + h, D: D + w]
    prev_loc = prev[D: D + h, D: D + w]
    u0_loc = u0_padk[D: D + h, D: D + w]
    h_eps = heaviside(new, p.eps)
    dphi = new - prev_loc
    flips = ((new >= 0) != (prev_loc >= 0)).astype(new.dtype)
    parts = jnp.stack([
        jnp.sum(u0_loc * h_eps), jnp.sum(h_eps),
        jnp.sum(dphi * dphi), jnp.sum(flips), jnp.sum(jnp.abs(dphi)),
    ])
    parts = lax.psum(parts, ("x", "y"))
    c1n, c2n = means_from_sums(parts[0], parts[1], sum_u, n_pix)
    delta = _delta_from_partials(parts, n_pix, p)
    return new, c1n, c2n, delta



def _chunk_iterate(pad, f, p: CVParams, red, black, ix, iy, nx, ny, D, k,
                   resync_edges=(True, True, True, True)):
    """k chunk iterations (leading replica resync + red/black sweeps) on
    a D-padded block or strip; returns (final, state before the last
    iteration). The loop body is exactly _sharded_chunk_jnp's."""
    cur = pad
    prev = pad
    for _ in range(k):
        prev = cur
        cur = _resync_replicas(cur, ix, iy, nx, ny, resync_edges, depth=D)
        cur = _sweep_local(cur, f, p, red, black, ix, iy, nx, ny,
                           resync_edges, depth=D)
    return cur, prev


def _sharded_chunk_overlap(phi, u0_padk, c1, c2, p: CVParams, k, ix, iy,
                           nx, ny, h, w, n_pix, sum_u):
    """Communication-avoiding chunk with halo-comm / interior-compute
    overlap (overlap x comm_k - the PP analog at scale).

    The chunk's interior runs on a LOCALLY edge-padded block - cells at
    depth >= 4k (top/left) / 2k (bottom/right) of the shard depend only
    on owned data through all k iterations, so that compute is
    data-independent of the concurrent 4k-deep ppermute exchange and
    XLA's async collectives hide the transfer behind it. Afterwards four
    3D-deep strips (D = 4k; a strip row is exact through k iterations
    iff it sits >= 4k rows from the strip's interior-facing fake edge,
    and the deepest rim row needed is 2D-1 from the pad edge) recompute
    the rim from the exchanged pad and overwrite it. Partials are
    computed here from the stitched (new, prev).
    """
    D = (u0_padk.shape[0] - h) // 2
    S = 3 * D
    ph, pw = h + 2 * D, w + 2 * D
    gi, gj = _global_coords((ph, pw), ix, iy, h, w, pad=D)
    valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
    red = ((gi + gj) % 2 == 0) & valid
    black = ((gi + gj) % 2 == 1) & valid
    f = (-p.nu - p.lambda1 * (u0_padk - c1) ** 2
         + p.lambda2 * (u0_padk - c2) ** 2)

    # interior: purely local; rim cells are overwritten below
    local = jnp.pad(phi, D, mode="edge")
    cur, prev = _chunk_iterate(local, f, p, red, black, ix, iy,
                               nx, ny, D, k)
    new = cur[D: D + h, D: D + w]
    prev_i = prev[D: D + h, D: D + w]

    # communication, independent of the interior compute above
    pad = exchange_halo2d(phi, D)

    def strip(rs, re, cs, ce, edges_s):
        return _chunk_iterate(pad[rs:re, cs:ce], f[rs:re, cs:ce], p,
                              red[rs:re, cs:ce], black[rs:re, cs:ce],
                              ix, iy, nx, ny, D, k, resync_edges=edges_s)

    n_s, n_p = strip(0, S, 0, pw, (True, False, True, True))
    s_s, s_p = strip(ph - S, ph, 0, pw, (False, True, True, True))
    w_s, w_p = strip(0, ph, 0, S, (True, True, True, False))
    e_s, e_p = strip(0, ph, pw - S, pw, (True, True, False, True))

    tw, bw = D, D // 2  # rim thickness: 4k top/left, 2k bottom/right

    def do_stitch(x, ns, ss, ws, es):
        x = x.at[0:tw, :].set(ns[D: D + tw, D: D + w])
        x = x.at[h - bw: h, :].set(
            ss[S - D - bw: S - D, D: D + w])
        x = x.at[:, 0:tw].set(ws[D: D + h, D: D + tw])
        x = x.at[:, w - bw: w].set(
            es[D: D + h, S - D - bw: S - D])
        return x

    new = do_stitch(new, n_s, s_s, w_s, e_s)
    prev_loc = do_stitch(prev_i, n_p, s_p, w_p, e_p)

    u0_loc = u0_padk[D: D + h, D: D + w]
    h_eps = heaviside(new, p.eps)
    dphi = new - prev_loc
    flips = ((new >= 0) != (prev_loc >= 0)).astype(new.dtype)
    parts = jnp.stack([
        jnp.sum(u0_loc * h_eps), jnp.sum(h_eps),
        jnp.sum(dphi * dphi), jnp.sum(flips), jnp.sum(jnp.abs(dphi)),
    ])
    parts = lax.psum(parts, ("x", "y"))
    c1n, c2n = means_from_sums(parts[0], parts[1], sum_u, n_pix)
    delta = _delta_from_partials(parts, n_pix, p)
    return new, c1n, c2n, delta


def _sharded_chunk_jnp_vec(phi, u0_padk, c1, c2, p: CVParams, k, l1, l2,
                           ix, iy, nx, ny, h, w, n_pix, sum_u):
    """Vector-valued twin of _sharded_chunk_jnp: one 4k-deep exchange,
    k frozen-means iterations with the channel-averaged weighted data
    term (SURVEY.md C9), per-channel means refreshed from the chunk's
    final partials."""
    D = (u0_padk.shape[0] - h) // 2
    pad = exchange_halo2d(phi, D)
    gi, gj = _global_coords(pad.shape, ix, iy, h, w, pad=D)
    valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
    red = ((gi + gj) % 2 == 0) & valid
    black = ((gi + gj) % 2 == 1) & valid
    l1 = jnp.asarray(l1, phi.dtype)
    l2 = jnp.asarray(l2, phi.dtype)
    f = (-p.nu - jnp.mean(l1 * (u0_padk - c1) ** 2, axis=-1)
         + jnp.mean(l2 * (u0_padk - c2) ** 2, axis=-1))

    prev = pad
    for _ in range(k):
        prev = pad
        pad = _resync_replicas(pad, ix, iy, nx, ny, depth=D)
        pad = _sweep_local(pad, f, p, red, black, ix, iy, nx, ny, depth=D)

    new = pad[D: D + h, D: D + w]
    prev_loc = prev[D: D + h, D: D + w]
    u0_loc = u0_padk[D: D + h, D: D + w]
    h_eps = heaviside(new, p.eps)
    dphi = new - prev_loc
    flips = ((new >= 0) != (prev_loc >= 0)).astype(new.dtype)
    c = u0_loc.shape[-1]
    parts = jnp.concatenate([
        jnp.sum(u0_loc * h_eps[..., None], axis=(0, 1)),
        jnp.stack([jnp.sum(h_eps), jnp.sum(dphi * dphi), jnp.sum(flips),
                   jnp.sum(jnp.abs(dphi))]),
    ])
    parts = lax.psum(parts, ("x", "y"))
    c1n, c2n = means_from_sums(parts[:c], parts[c], sum_u, n_pix)
    delta = _delta_from_partials(parts, n_pix, p, offset=c - 1)
    return new, c1n, c2n, delta


def _reinit_refresh_means(phi, c1, c2, n, u0_local, s_u, n_pix, p, vec):
    """Cond-gated redistance + psum'd means refresh (reinit rescales
    |phi|, moving H_eps everywhere, so carried means go stale). Shared
    by the while_loop driver and the trace program."""
    def fire(args):
        ph, a, b = args
        ph = _sharded_reinit(ph, n, p, always=True)
        hr = heaviside(ph, p.eps)
        if vec:
            suh = lax.psum(jnp.sum(u0_local * hr[..., None], axis=(0, 1)),
                           ("x", "y"))
        else:
            suh = lax.psum(jnp.sum(u0_local * hr), ("x", "y"))
        sh = lax.psum(jnp.sum(hr), ("x", "y"))
        a = suh / jnp.maximum(sh, 1e-30)
        b = (s_u - suh) / jnp.maximum(n_pix - sh, 1e-30)
        return ph, a, b

    return lax.cond((n + 1) % p.reinit_every == 0, fire,
                    lambda args: args, (phi, c1, c2))


def _run_sharded(u0, phi0, p: CVParams, nx, ny, max_iter, fixed,
                 lambdas=None, halo="ppermute", comm_k=1):
    """shard_map body: the full solver on a local (h, w[, C]) block."""
    ix = lax.axis_index("x")
    iy = lax.axis_index("y")
    h, w = u0.shape[:2]
    n_pix = jnp.asarray(nx * h * ny * w, u0.dtype)
    vec = u0.ndim == 3

    if vec:
        u0_pad = jax.vmap(lambda ch: exchange_halo2d(ch, _D),
                          in_axes=2, out_axes=2)(u0)
        l1, l2 = lambdas
    else:
        u0_pad = exchange_halo2d(u0, _D)
    # initial region means: the smooth-Heaviside reduction, psum'd
    h0 = heaviside(phi0, p.eps)
    if vec:
        s_uh = lax.psum(jnp.sum(u0 * h0[..., None], axis=(0, 1)),
                        ("x", "y"))
        s_u = lax.psum(jnp.sum(u0, axis=(0, 1)), ("x", "y"))
    else:
        s_uh = lax.psum(jnp.sum(u0 * h0), ("x", "y"))
        s_u = lax.psum(jnp.sum(u0), ("x", "y"))
    s_h = lax.psum(jnp.sum(h0), ("x", "y"))
    c1 = s_uh / jnp.maximum(s_h, 1e-30)
    c2 = (s_u - s_uh) / jnp.maximum(n_pix - s_h, 1e-30)

    if comm_k > 1:
        # communication-avoiding chunked loop (see _sharded_chunk_jnp);
        # the loop-invariant deep-halo image is built once outside the
        # while_loop
        D = 4 * comm_k
        if vec:
            u0_padk = jax.vmap(lambda ch: exchange_halo2d(ch, D),
                               in_axes=2, out_axes=2)(u0)
        else:
            u0_padk = exchange_halo2d(u0, D)

        def run_chunk(state, size):
            phi, a, b, n, _, streak = state
            if halo == "overlap":
                phi, a, b, delta = _sharded_chunk_overlap(
                    phi, u0_padk, a, b, p, size, ix, iy, nx, ny, h, w,
                    n_pix, s_u)
            elif vec:
                phi, a, b, delta = _sharded_chunk_jnp_vec(
                    phi, u0_padk, a, b, p, size, l1, l2, ix, iy, nx, ny,
                    h, w, n_pix, s_u)
            else:
                phi, a, b, delta = _sharded_chunk_jnp(
                    phi, u0_padk, a, b, p, size, ix, iy, nx, ny, h, w,
                    n_pix, s_u)
            # a below-tol chunk check credits its full SIZE iterations:
            # patience stays iteration-denominated across drivers
            # (chunk-granular)
            streak = jnp.where(delta < p.tol, streak + size, 0)
            return (phi, a, b, n + size, delta, streak)

        def not_stopped(state):
            _, _, _, n, delta, streak = state
            done = jnp.logical_and(streak >= p.patience, n >= p.min_iter)
            diverged = jnp.logical_and(
                n > 0, jnp.logical_not(jnp.isfinite(delta)))
            return jnp.logical_not(jnp.logical_or(done, diverged))

        full = (max_iter // comm_k) * comm_k
        rem = max_iter - full

        def chunk_cond(state):
            if fixed:
                return state[3] < full
            return jnp.logical_and(state[3] < full, not_stopped(state))

        init = (phi0, c1, c2, jnp.int32(0),
                jnp.asarray(jnp.inf, u0.dtype), jnp.int32(0))
        state = lax.while_loop(chunk_cond,
                               lambda st: run_chunk(st, comm_k), init)
        if rem:
            pred = state[3] < max_iter
            if not fixed:
                pred = jnp.logical_and(pred, not_stopped(state))
            state = lax.cond(pred, lambda st: run_chunk(st, rem),
                             lambda st: st, state)
        phi, c1, c2, iters, delta, _ = state
        return phi, c1, c2, iters, delta

    def body(state):
        phi, c1, c2, n, _, streak = state
        if vec:
            phi, c1, c2, delta = _sharded_iteration_vec(
                phi, u0_pad, c1, c2, p, l1, l2, ix, iy, nx, ny, h, w,
                n_pix, s_u)
        else:
            phi, c1, c2, delta = _sharded_iteration(
                phi, u0_pad, c1, c2, p, ix, iy, nx, ny, h, w, n_pix, s_u,
                halo=halo)
        if p.reinit_every:
            phi, c1, c2 = _reinit_refresh_means(phi, c1, c2, n, u0, s_u,
                                                n_pix, p, vec)
        streak = jnp.where(delta < p.tol, streak + 1, 0)
        return (phi, c1, c2, n + 1, delta, streak)

    def cond(state):
        _, _, _, n, delta, streak = state
        if fixed:
            return n < max_iter
        return loop_continue(n, delta, streak, p, max_iter)

    init = (phi0, c1, c2, jnp.int32(0), jnp.asarray(jnp.inf, u0.dtype),
            jnp.int32(0))
    phi, c1, c2, iters, delta, _ = lax.while_loop(cond, body, init)
    return phi, c1, c2, iters, delta


def _check_halo(halo: str, H: int, W: int, nx: int, ny: int):
    if halo not in ("ppermute", "overlap"):
        raise ValueError(f"unknown halo mechanism {halo!r}")
    if halo == "overlap" and min(H // nx, W // ny) < 16:
        raise ValueError("halo='overlap' needs shards of at least 16x16 "
                         "(the rim strips span 16 rows/cols)")


def segment_sharded(u0, p: CVParams = CVParams(), mesh: Optional[Mesh] = None,
                    phi0: Optional[jax.Array] = None,
                    max_iter: Optional[int] = None, fixed: bool = False,
                    lambda1=None, lambda2=None,
                    halo: str = "ppermute",
                    comm_k: int = 1) -> SegResult:
    """Segment one large image sharded over a 2D ('x', 'y') device mesh.

    u0: (H, W) grayscale or (H, W, C) vector-valued (channels replicated,
    per-channel lambda1/lambda2 tuples supported), with H % nx == 0 and
    W % ny == 0. phi is returned with the input's spatial sharding.
    Tolerance mode by default; fixed=True runs exactly max_iter iterations
    (eval config 4 benchmarking).

    comm_k: communication-avoiding chunking - exchange a 4k-deep halo
    once per comm_k iterations and run them locally with frozen means
    (the frozen-means-per-chunk trajectory class; grayscale and
    vector-valued images). Collective latency per iteration drops
    comm_k-fold; convergence is checked per chunk.

    halo: exchange schedule - 'ppermute' (exchange, then sweep; the
    default) or 'overlap' (the block interior sweeps from local data
    while the exchange runs, then the rim is recomputed from the
    exchanged halo; grayscale only).
    """
    if mesh is None:
        raise ValueError("segment_sharded needs a mesh "
                         "(parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = u0.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {u0.shape} not divisible by mesh "
                         f"({nx}, {ny})")
    cap = max_iter if max_iter is not None else p.max_iter
    _check_halo(halo, H, W, nx, ny)
    if comm_k < 1:
        raise ValueError("comm_k must be >= 1")
    if comm_k > 1:
        if p.reinit_every:
            raise ValueError(
                "comm_k > 1 supports no reinit cadence (frozen-means "
                "chunks have no per-iteration boundary to hang it on)")
        if halo == "overlap" and u0.ndim == 3:
            raise ValueError("overlap x comm_k supports grayscale only")
        if 4 * comm_k > min(H // nx, W // ny):
            raise ValueError(
                f"comm_k={comm_k} needs 4*comm_k-deep halos, larger than "
                f"the shard ({H // nx}, {W // ny})")
    vec = u0.ndim == 3
    if vec:
        if halo != "ppermute":
            raise ValueError(f"halo={halo!r} supports grayscale images only")
        lambdas = p.channel_lambdas(u0.shape[-1], lambda1, lambda2)
    else:
        # fold scalar overrides into the (static) params the solver bakes in
        p = _fold_scalar_lambdas(p, lambda1, lambda2)
        lambdas = None
    if p.reinit_every and p.reinit_steps > min(H // nx, W // ny):
        raise ValueError(
            f"reinit_steps={p.reinit_steps} exceeds the shard size "
            f"({H // nx}, {W // ny}); the halo-aware redistance exchanges a "
            f"depth-reinit_steps halo from immediate neighbors only - lower "
            f"reinit_steps or use a coarser mesh")

    run = _build_program(p, mesh, nx, ny, cap, fixed, vec, lambdas, halo,
                         comm_k)

    spec = NamedSharding(mesh, P("x", "y", None) if vec else P("x", "y"))
    phi_spec = NamedSharding(mesh, P("x", "y"))
    if isinstance(u0, jax.core.Tracer):
        # Called inside an outer jit trace (a larger jitted pipeline, or
        # a single-dispatch benchmark): jax forbids set_mesh under jit,
        # so the CALLER must hold `with jax.set_mesh(mesh):` open around
        # the jitted call. device_put lowers to a sharding constraint
        # here; phi0 must be supplied (the init builds via shard_map +
        # set_mesh).
        if phi0 is None:
            raise ValueError(
                "segment_sharded under an outer jit needs an explicit "
                "phi0 (init_phi runs its own set_mesh)")
        phi, c1, c2, iters, delta = run(jax.device_put(u0, spec),
                                        jax.device_put(phi0, phi_spec))
        return SegResult(phi, phi >= 0, iters, delta, c1, c2)
    u0 = jax.device_put(u0, spec)
    if phi0 is None:
        phi0 = _make_phi0((H, W), p.init, u0.dtype, mesh)
    else:
        phi0 = jax.device_put(phi0, phi_spec)
    with jax.set_mesh(mesh):
        phi, c1, c2, iters, delta = run(u0, phi0)
    return SegResult(phi, phi >= 0, iters, delta, c1, c2)


def segment_multiphase_sharded(u0, p: CVParams = CVParams(),
                               mesh: Optional[Mesh] = None,
                               m_sets: int = 2,
                               phis0: Optional[jax.Array] = None,
                               max_iter: Optional[int] = None,
                               fixed: bool = False,
                               halo: str = "ppermute",
                               comm_k: int = 1):
    """Multiphase Vese-Chan over the 2D device mesh (SURVEY.md C10 x SP).

    Returns a models.multiphase.MultiphaseResult with phis sharded
    P(None, 'x', 'y'). u0 must be (H, W[, C]) divisible by the mesh.

    halo: 'ppermute' (default) or 'overlap' for the per-iteration
    level-set exchanges. comm_k: communication-avoiding chunking - one
    8*comm_k-deep exchange of every level set per comm_k coupled
    iterations with frozen phase means (the multiphase twin of the
    scalar comm_k class; convergence is chunk-granular and patience is
    iteration-denominated).
    """
    from ..models.multiphase import MultiphaseResult, labels_from_phis

    if mesh is None:
        raise ValueError("needs a mesh (parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = u0.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {u0.shape} not divisible by mesh")
    _check_halo(halo, H, W, nx, ny)
    if halo == "overlap" and comm_k > 1:
        raise ValueError("multiphase overlap x comm_k not supported; "
                         "use halo='ppermute' with comm_k")
    if comm_k < 1:
        raise ValueError("comm_k must be >= 1")
    if comm_k > 1:
        if p.reinit_every:
            raise ValueError("multiphase comm_k > 1 supports no reinit "
                             "cadence (frozen-means chunks)")
        if 8 * comm_k > min(H // nx, W // ny):
            raise ValueError(
                f"multiphase comm_k={comm_k} needs 8*comm_k-deep halos, "
                f"larger than the shard ({H // nx}, {W // ny})")
    cap = max_iter if max_iter is not None else p.max_iter
    vec = u0.ndim == 3

    run = _build_mp_program(p, mesh, nx, ny, cap, fixed, m_sets, vec,
                            halo, comm_k)
    u0 = jax.device_put(u0, NamedSharding(
        mesh, P("x", "y", None) if vec else P("x", "y")))
    if phis0 is None:
        from ..models.multiphase import init_multiphase
        phis0 = init_multiphase((H, W), m_sets, dtype=u0.dtype)
    phis0 = jax.device_put(phis0, NamedSharding(mesh, P(None, "x", "y")))
    with jax.set_mesh(mesh):
        phis, iters, delta = run(u0, phis0)
    # phase means of the final state, computed sharded-agnostically
    from ..models.multiphase import phase_means
    cs = jnp.stack(phase_means(u0, phis, p.eps))
    return MultiphaseResult(phis, labels_from_phis(phis), iters, delta, cs)


@functools.lru_cache(maxsize=64)
def _build_mp_program(p, mesh, nx, ny, cap, fixed, m_sets, vec=False,
                      halo="ppermute", comm_k=1):
    def local_fn(u0_loc, phis_loc):
        ix = lax.axis_index("x")
        iy = lax.axis_index("y")
        h, w = u0_loc.shape[:2]
        n_pix = jnp.asarray(nx * h * ny * w, u0_loc.dtype)

        if comm_k > 1:
            # communication-avoiding chunked loop (the multiphase twin
            # of the scalar comm_k loop; see _sharded_multiphase_chunk)
            D = 8 * comm_k
            if vec:
                u0_padk = jax.vmap(lambda ch: exchange_halo2d(ch, D),
                                   in_axes=2, out_axes=2)(u0_loc)
            else:
                u0_padk = exchange_halo2d(u0_loc, D)
            cs0 = jnp.stack(_sharded_phase_means(u0_loc, phis_loc, p))

            def run_chunk(state, size):
                phis, cs, n, _, streak = state
                phis, cs, delta = _sharded_multiphase_chunk(
                    phis, u0_padk, cs, p, size, ix, iy, nx, ny, h, w,
                    n_pix)
                streak = jnp.where(delta < p.tol, streak + size, 0)
                return (phis, cs, n + size, delta, streak)

            def not_stopped(state):
                _, _, n, delta, streak = state
                done = jnp.logical_and(streak >= p.patience,
                                       n >= p.min_iter)
                diverged = jnp.logical_and(
                    n > 0, jnp.logical_not(jnp.isfinite(delta)))
                return jnp.logical_not(jnp.logical_or(done, diverged))

            full = (cap // comm_k) * comm_k
            rem = cap - full

            def chunk_cond(state):
                if fixed:
                    return state[2] < full
                return jnp.logical_and(state[2] < full,
                                       not_stopped(state))

            init = (phis_loc, cs0, jnp.int32(0),
                    jnp.asarray(jnp.inf, u0_loc.dtype), jnp.int32(0))
            state = lax.while_loop(chunk_cond,
                                   lambda st: run_chunk(st, comm_k), init)
            if rem:
                pred = state[2] < cap
                if not fixed:
                    pred = jnp.logical_and(pred, not_stopped(state))
                state = lax.cond(pred, lambda st: run_chunk(st, rem),
                                 lambda st: st, state)
            phis, _, iters, delta, _ = state
            return phis, iters, delta

        if vec:
            u0_pad = jax.vmap(lambda ch: exchange_halo2d(ch, _D),
                              in_axes=2, out_axes=2)(u0_loc)
        else:
            u0_pad = exchange_halo2d(u0_loc, _D)

        def body(state):
            phis, n, _, streak = state
            phis, delta = _sharded_multiphase_iteration(
                phis, u0_pad, p, ix, iy, nx, ny, h, w, n_pix, halo=halo)
            phis = jax.vmap(lambda ph: _sharded_reinit(ph, n, p))(phis) \
                if p.reinit_every else phis
            streak = jnp.where(delta < p.tol, streak + 1, 0)
            return (phis, n + 1, delta, streak)

        def cond(state):
            _, n, delta, streak = state
            if fixed:
                return n < cap
            return loop_continue(n, delta, streak, p, cap)

        init = (phis_loc, jnp.int32(0),
                jnp.asarray(jnp.inf, u0_loc.dtype), jnp.int32(0))
        phis, iters, delta, _ = lax.while_loop(cond, body, init)
        return phis, iters, delta

    mapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P("x", "y", None) if vec else P("x", "y"),
                  P(None, "x", "y")),
        out_specs=(P(None, "x", "y"), P(), P()),
        check_vma=False)
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _build_program(p, mesh, nx, ny, cap, fixed, vec=False, lambdas=None,
                   halo="ppermute", comm_k=1):
    """Cache the jitted shard_map program (a fresh closure per call would
    retrace on every segment_sharded invocation - ~2s per call at 4K)."""

    def local_fn(u0_loc, phi0_loc):
        return _run_sharded(u0_loc, phi0_loc, p, nx, ny, cap, fixed,
                            lambdas=lambdas, halo=halo, comm_k=comm_k)

    u_spec = P("x", "y", None) if vec else P("x", "y")
    mapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(u_spec, P("x", "y")),
        out_specs=(P("x", "y"), P(), P(), P(), P()),
        check_vma=False)
    return jax.jit(mapped)


def _make_phi0(shape, kind, dtype, mesh):
    """Initialize phi directly sharded (each device builds its tile)."""
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = shape
    h, w = H // nx, W // ny

    def local_init():
        ix = lax.axis_index("x")
        iy = lax.axis_index("y")
        if kind == "checkerboard":
            v = _local_checkerboard((h, w), ix, iy, h, w, dtype)
        elif kind in ("circle", "disk"):
            v = _local_circle((h, w), ix, iy, h, w, H, W, dtype)
        elif kind in ("small disk", "small-disk"):
            v = _local_circle((h, w), ix, iy, h, w, H, W, dtype,
                              r=min(H, W) / 8.0)
        elif kind == "rect":
            v = _local_rect((h, w), ix, iy, h, w, H, W, dtype)
        else:
            raise ValueError(f"unsupported sharded init {kind!r}")
        # iotas above are built for the padded convention; build unpadded
        return v

    fn = shard_map(local_init, mesh=mesh, in_specs=(),
                   out_specs=P("x", "y"))
    with jax.set_mesh(mesh):
        return jax.jit(fn)()


class ShardedTrace(NamedTuple):
    phi: jax.Array
    mask: jax.Array
    energy: jax.Array   # (iters,)
    delta: jax.Array    # (iters,)
    c1: jax.Array       # (iters[, C])
    c2: jax.Array


@functools.lru_cache(maxsize=64)
def _build_trace_program(p, mesh, nx, ny, iters, vec, lambdas, halo):
    def local_fn(u0_loc, phi0_loc):
        ix = lax.axis_index("x")
        iy = lax.axis_index("y")
        h, w = u0_loc.shape[:2]
        n_pix = jnp.asarray(nx * h * ny * w, u0_loc.dtype)

        if vec:
            u0_pad = jax.vmap(lambda ch: exchange_halo2d(ch, _D),
                              in_axes=2, out_axes=2)(u0_loc)
            l1, l2 = lambdas
        else:
            u0_pad = exchange_halo2d(u0_loc, _D)
        u0l = u0_loc
        h0 = heaviside(phi0_loc, p.eps)
        if vec:
            s_uh = lax.psum(jnp.sum(u0l * h0[..., None], axis=(0, 1)),
                            ("x", "y"))
            s_u = lax.psum(jnp.sum(u0l, axis=(0, 1)), ("x", "y"))
        else:
            s_uh = lax.psum(jnp.sum(u0l * h0), ("x", "y"))
            s_u = lax.psum(jnp.sum(u0l), ("x", "y"))
        s_h = lax.psum(jnp.sum(h0), ("x", "y"))
        c1 = s_uh / jnp.maximum(s_h, 1e-30)
        c2 = (s_u - s_uh) / jnp.maximum(n_pix - s_h, 1e-30)

        def body(carry, _):
            phi, c1, c2, n = carry
            if vec:
                phi, c1n, c2n, delta = _sharded_iteration_vec(
                    phi, u0_pad, c1, c2, p, l1, l2, ix, iy, nx, ny, h, w,
                    n_pix, s_u)
            else:
                phi, c1n, c2n, delta = _sharded_iteration(
                    phi, u0_pad, c1, c2, p, ix, iy, nx, ny, h, w, n_pix,
                    s_u, halo=halo)
            e = _sharded_energy(phi, u0l, c1n, c2n, p, lambdas)
            if p.reinit_every:
                phi, c1n, c2n = _reinit_refresh_means(
                    phi, c1n, c2n, n, u0l, s_u, n_pix, p, vec)
            return (phi, c1n, c2n, n + 1), (e, delta, c1, c2)

        (phi, _, _, _), (es, ds, c1s, c2s) = lax.scan(
            body, (phi0_loc, c1, c2, jnp.int32(0)), None, length=iters)
        return phi, es, ds, c1s, c2s

    u_spec = P("x", "y", None) if vec else P("x", "y")
    mapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(u_spec, P("x", "y")),
        out_specs=(P("x", "y"), P(), P(), P(), P()),
        check_vma=False)
    return jax.jit(mapped)


def segment_sharded_fixed_trace(u0, p: CVParams = CVParams(),
                                mesh: Optional[Mesh] = None,
                                iters: int = 100,
                                phi0: Optional[jax.Array] = None,
                                lambda1=None, lambda2=None,
                                halo: str = "ppermute") -> ShardedTrace:
    """Fixed-iteration SHARDED run with per-iteration energy/delta/means
    traces (the parity artifact of BASELINE.json:5, computed with psum'd
    reductions instead of a host gather). Mirrors models/scalar.py
    segment_fixed's trace convention: energy after each sweep, means
    recomputed from the post-sweep phi.
    """
    if mesh is None:
        raise ValueError("segment_sharded_fixed_trace needs a mesh")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = u0.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {u0.shape} not divisible by mesh "
                         f"({nx}, {ny})")
    _check_halo(halo, H, W, nx, ny)
    vec = u0.ndim == 3
    if vec:
        if halo != "ppermute":
            raise ValueError(f"halo={halo!r} supports grayscale only")
        lambdas = p.channel_lambdas(u0.shape[-1], lambda1, lambda2)
    else:
        p = _fold_scalar_lambdas(p, lambda1, lambda2)
        lambdas = None

    run = _build_trace_program(p, mesh, nx, ny, iters, vec, lambdas, halo)
    spec = NamedSharding(mesh, P("x", "y", None) if vec else P("x", "y"))
    u0 = jax.device_put(u0, spec)
    if phi0 is None:
        phi0 = _make_phi0((H, W), p.init, u0.dtype, mesh)
    else:
        phi0 = jax.device_put(phi0, NamedSharding(mesh, P("x", "y")))
    with jax.set_mesh(mesh):
        phi, es, ds, c1s, c2s = run(u0, phi0)
    return ShardedTrace(phi, phi >= 0, es, ds, c1s, c2s)


def _sharded_multiphase_chunk(phis, u0_padk, cs, p: CVParams, k, ix, iy,
                              nx, ny, h, w, n_pix):
    """Communication-avoiding MULTIPHASE chunk: one deep halo exchange
    of every level set, then k coupled iterations locally with FROZEN
    phase means (refreshed from the chunk-final state) - the multiphase
    twin of _sharded_chunk_jnp. Halo depth D = 8 * comm_k covers the
    coupled iteration's conservative composite reach (8 up / 4 down per
    iteration: phi_1's sweep reads NEW phi_0 through the data term).

    Returns (phis_new, cs_new, label_flips_fraction) where flips are
    the LAST in-chunk iteration's transition.
    """
    m_sets = phis.shape[0]
    D = (u0_padk.shape[0] - h) // 2
    u0_loc = u0_padk[D: D + h, D: D + w]

    pads = [exchange_halo2d(phis[m], D) for m in range(m_sets)]
    gi, gj = _global_coords(pads[0].shape[:2], ix, iy, h, w, pad=D)
    valid = ((gi >= 0) & (gi < nx * h) & (gj >= 0) & (gj < ny * w))
    red = ((gi + gj) % 2 == 0) & valid
    black = ((gi + gj) % 2 == 1) & valid

    def hside(x):
        return heaviside(x, p.eps)

    prev = list(pads)
    for _ in range(k):
        prev = list(pads)
        pads = [_resync_replicas(pd, ix, iy, nx, ny, depth=D)
                for pd in pads]
        for m in range(m_sets):
            hs_pad = [hside(pads[kk]) for kk in range(m_sets)]
            f = _mp_coupling_f(hs_pad, u0_padk, cs, p, m, m_sets,
                               phis.dtype)
            pads[m] = _sweep_local(pads[m], f, p, red, black, ix, iy,
                                   nx, ny, depth=D)

    new = jnp.stack([pd[D: D + h, D: D + w] for pd in pads])
    prev_loc = jnp.stack([pd[D: D + h, D: D + w] for pd in prev])

    def labels(ph):
        lab = jnp.zeros(ph.shape[1:], jnp.int32)
        for m in range(m_sets):
            lab = lab | ((ph[m] >= 0).astype(jnp.int32) << m)
        return lab

    flips = lax.psum(
        jnp.sum((labels(new) != labels(prev_loc)).astype(phis.dtype))
        + 0.0 * jnp.sum(new), ("x", "y"))
    cs_new = jnp.stack(_sharded_phase_means(u0_loc, new, p))
    return new, cs_new, flips / n_pix


def _sharded_multiphase_energy(u0_loc, phis, p: CVParams):
    """psum'd multiphase energy of local blocks, exactly matching
    models/multiphase.multiphase_energy on the assembled image (forward
    differences read neighbors through a 1-deep halo; global means)."""
    from ..ops.numerics import dirac

    cs = _sharded_phase_means(u0_loc, phis, p)
    m_sets = phis.shape[0]
    vec = u0_loc.ndim == 3
    hs = [heaviside(phis[m], p.eps) for m in range(m_sets)]
    fit = jnp.zeros((), u0_loc.dtype)
    for sbit in range(2 ** m_sets):
        wgt = None
        for m in range(m_sets):
            factor = hs[m] if (sbit >> m) & 1 else (1.0 - hs[m])
            wgt = factor if wgt is None else wgt * factor
        if vec:
            d = jnp.mean((u0_loc - cs[sbit]) ** 2, axis=-1)
        else:
            d = (u0_loc - cs[sbit]) ** 2
        fit = fit + jnp.sum(d * wgt)
    reg = jnp.zeros((), u0_loc.dtype)
    for m in range(m_sets):
        pad1 = exchange_halo2d(phis[m], 1)
        ph = pad1[1:-1, 1:-1]
        gx = pad1[2:, 1:-1] - ph
        gy = pad1[1:-1, 2:] - ph
        reg = reg + p.mu * jnp.sum(dirac(phis[m], p.eps)
                                   * jnp.sqrt(gx * gx + gy * gy))
        reg = reg + p.nu * jnp.sum(hs[m])
    return lax.psum(fit + reg, ("x", "y"))


class MultiphaseShardedTrace(NamedTuple):
    phis: jax.Array     # (M, H, W), sharded P(None, 'x', 'y')
    labels: jax.Array   # (H, W) int32
    energy: jax.Array   # (iters,)
    delta: jax.Array    # (iters,) label-flip fractions


@functools.lru_cache(maxsize=64)
def _build_mp_trace_program(p, mesh, nx, ny, iters, m_sets, vec, halo):
    def local_fn(u0_loc, phis_loc):
        ix = lax.axis_index("x")
        iy = lax.axis_index("y")
        h, w = u0_loc.shape[:2]
        n_pix = jnp.asarray(nx * h * ny * w, u0_loc.dtype)
        if vec:
            u0_pad = jax.vmap(lambda ch: exchange_halo2d(ch, _D),
                              in_axes=2, out_axes=2)(u0_loc)
        else:
            u0_pad = exchange_halo2d(u0_loc, _D)

        def body(carry, _):
            phis, n = carry
            phis, delta = _sharded_multiphase_iteration(
                phis, u0_pad, p, ix, iy, nx, ny, h, w, n_pix, halo=halo)
            e = _sharded_multiphase_energy(u0_loc, phis, p)
            if p.reinit_every:
                phis = jax.vmap(lambda ph: _sharded_reinit(ph, n, p))(phis)
            return (phis, n + 1), (e, delta)

        (phis, _), (es, ds) = lax.scan(
            body, (phis_loc, jnp.int32(0)), None, length=iters)
        return phis, es, ds

    u_spec = P("x", "y", None) if vec else P("x", "y")
    mapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(u_spec, P(None, "x", "y")),
        out_specs=(P(None, "x", "y"), P(), P()),
        check_vma=False)
    return jax.jit(mapped)


def segment_multiphase_sharded_fixed_trace(u0, p: CVParams = CVParams(),
                                           mesh: Optional[Mesh] = None,
                                           iters: int = 100,
                                           m_sets: int = 2,
                                           phis0: Optional[jax.Array] = None,
                                           halo: str = "ppermute"
                                           ) -> MultiphaseShardedTrace:
    """Fixed-iteration SHARDED multiphase run with per-iteration psum'd
    energy and label-flip traces (the observability surface VERDICT r2
    missing #4 asked for; mirrors segment_multiphase_fixed's schedule:
    energy after each coupled iteration, before any reinit)."""
    from ..models.multiphase import labels_from_phis

    if mesh is None:
        raise ValueError("needs a mesh (parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = u0.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {u0.shape} not divisible by mesh")
    _check_halo(halo, H, W, nx, ny)
    vec = u0.ndim == 3

    run = _build_mp_trace_program(p, mesh, nx, ny, iters, m_sets, vec, halo)
    u0 = jax.device_put(u0, NamedSharding(
        mesh, P("x", "y", None) if vec else P("x", "y")))
    if phis0 is None:
        from ..models.multiphase import init_multiphase
        phis0 = init_multiphase((H, W), m_sets, dtype=u0.dtype)
    phis0 = jax.device_put(phis0, NamedSharding(mesh, P(None, "x", "y")))
    with jax.set_mesh(mesh):
        phis, es, ds = run(u0, phis0)
    return MultiphaseShardedTrace(phis, labels_from_phis(phis), es, ds)
