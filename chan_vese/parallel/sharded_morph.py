"""Communication-avoiding sharded morphological drivers (comm_k chunks).

The GSPMD sharded morph/GAC drivers (models/morph.py, models/morph_gac
.py) exchange depth-1 halos EVERY iteration - the compiler's partition
of the per-iteration program. This module applies the framework's
comm_k theme (parallel/sharded.py, SURVEY.md §2.9 comm row) to the
morphological family: ONE deep halo exchange per k iterations, with the
k in-tile iterations running on the halo-padded local block and the
validity rim shrinking by the per-iteration reach R (_reach: 1+2s for
ACWE, 2+2s for GAC) - halo depth D = R*k keeps the owned block exact
through all k iterations.

The morphological family is the BEST case for this scheme:

  * MorphGAC has no reductions in its loop body at all, so a k-deep
    chunk is trajectory-EXACT for any k - the chunked sharded driver
    computes bitwise the same level set as the per-iteration GSPMD
    path, with 1/k the collectives.
  * MorphACWE's only reduction is the region means: frozen per chunk
    (ONE psum pair per k iterations), the frozen-means-per-chunk
    trajectory class (k=1 == the published per-iteration scheme
    bitwise).

Replica/Neumann semantics at the global boundary: exchange_halo2d fills
global-edge halos with edge replicates (clamped-index semantics), and
the global-edge pads are REFRESHED from the current edge row/column
(_refresh_global_pads) before EVERY elementary stencil op - force,
balloon, attraction, and each sup_inf/inf_sup of a smoothing cycle
separately. The per-op granularity is load-bearing: the pads evolve
under each op like fake rows, so after any single op a pad cell no
longer equals the edge value an unsharded clamped shift would read
(measured: refreshing only between iterations leaves ~0.4% of pixels
wrong on a 96x128 GAC run). With per-op refresh a pad cell always
holds exactly the current edge value at every read, which makes the
owned block bitwise-exact - the analog of parallel/sharded.py's
per-half-sweep replica-rim resync (depth-D,
purely local, zero communication). Interior-edge pads are NOT
refreshed (no intra-chunk communication - that is the point); their
corruption travels R cells per iteration and stays strictly inside the
discarded halo.

Convergence is chunk-granular exactly as the sharded PDE comm_k loop
(parallel/sharded.py): the flip metric is the psum'd CHUNK
flip fraction (with even k a period-2 limit cycle of the alternating
smoothing reads exactly 0, subsuming the 2-cycle detector), a
below-tol chunk credits its full k iterations to the patience streak,
and max_iter stays an exact cap (full chunks in the while_loop + one
static remainder chunk).

Per-shard compute is the jnp iteration (shift + min/max - the program
class XLA fuses well at shard-local sizes).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.morph import dilate8, erode8, inf_sup, sup_inf
from ..ops.numerics import shift_down, shift_left, shift_right, shift_up
from ..params import CVParams
from .halo import exchange_halo2d, exchange_halo2d_batched

_TINY = 1e-8  # binary_means' empty-region guard (ops/morph.py)


def _reach(kind: str, smoothing: int) -> int:
    """Neighbor reach of ONE full iteration: the force step (1 for ACWE's
    central differences, 2 for GAC's balloon then attraction) plus 2 per
    smoothing cycle (two 1-reach operators each)."""
    return (1 if kind == "acwe" else 2) + 2 * smoothing


def _refresh_global_pads(xp, depth: int, axes=("x", "y")):
    """Overwrite the depth-deep pad strips of global-boundary shards with
    clamped-edge replicas of the CURRENT state (rows, then columns of
    the row-fixed array so corners clamp to the (0, 0) pixel exactly as
    composed clamped shifts do). Interior-edge pads pass through
    untouched - their validity is the halo-depth budget's business."""
    ax_r, ax_c = axes
    nx, ny = lax.axis_size(ax_r), lax.axis_size(ax_c)
    ix, iy = lax.axis_index(ax_r), lax.axis_index(ax_c)
    d = depth
    top = jnp.where(ix == 0,
                    jnp.broadcast_to(xp[d:d + 1, :], (d, xp.shape[1])),
                    xp[:d, :])
    bot = jnp.where(ix == nx - 1,
                    jnp.broadcast_to(xp[-d - 1:-d, :], (d, xp.shape[1])),
                    xp[-d:, :])
    xp = jnp.concatenate([top, xp[d:-d, :], bot], axis=0)
    left = jnp.where(iy == 0,
                     jnp.broadcast_to(xp[:, d:d + 1], (xp.shape[0], d)),
                     xp[:, :d])
    right = jnp.where(iy == ny - 1,
                      jnp.broadcast_to(xp[:, -d - 1:-d],
                                       (xp.shape[0], d)),
                      xp[:, -d:])
    return jnp.concatenate([left, xp[:, d:-d], right], axis=1)


def _smooth_padded(lsp, kc, smoothing: int, D: int):
    """``smoothing`` alternating SIoIS/ISoSI cycles on the padded block,
    refreshing global-edge pads before each elementary op (module
    docstring). ``kc`` is the traced smoothing-call counter (ops/morph.
    cycle_op's alternation)."""
    def siois(v):  # cycle_op even branch: sup_inf(inf_sup(v))
        v = inf_sup(_refresh_global_pads(v, D))
        return sup_inf(_refresh_global_pads(v, D))

    def isosi(v):  # odd branch: inf_sup(sup_inf(v))
        v = sup_inf(_refresh_global_pads(v, D))
        return inf_sup(_refresh_global_pads(v, D))

    for i in range(smoothing):
        lsp = lax.cond((kc + i) % 2 == 0,
                       lambda v: siois(v), lambda v: isosi(v), lsp)
    return lsp


def _check_geom(H, W, nx, ny, D):
    if H % nx or W % ny:
        raise ValueError(f"image {H}x{W} not divisible by mesh "
                         f"{nx}x{ny}")
    h, w = H // nx, W // ny
    if D > min(h, w):
        raise ValueError(
            f"comm_k halo depth {D} exceeds local block {h}x{w}; "
            f"lower comm_k or the mesh size")
    return h, w


def _not_stopped(p: CVParams):
    def fn(state):
        _, n, delta, streak = state
        done = jnp.logical_and(streak >= p.patience, n >= p.min_iter)
        diverged = jnp.logical_and(n > 0,
                                   jnp.logical_not(jnp.isfinite(delta)))
        return jnp.logical_not(jnp.logical_or(done, diverged))
    return fn


def _chunk_loop(p: CVParams, comm_k: int, run_chunk, ls0_loc, dtype):
    """Shared tolerance loop: full comm_k chunks in a while_loop + one
    static remainder chunk, exact max_iter cap."""
    not_stopped = _not_stopped(p)
    full = (p.max_iter // comm_k) * comm_k
    rem = p.max_iter - full

    def cond(state):
        return jnp.logical_and(state[1] < full, not_stopped(state))

    init = (ls0_loc, jnp.int32(0), jnp.asarray(jnp.inf, dtype),
            jnp.int32(0))
    state = lax.while_loop(cond, lambda st: run_chunk(st, comm_k), init)
    if rem:
        state = lax.cond(
            jnp.logical_and(state[1] < p.max_iter, not_stopped(state)),
            lambda st: run_chunk(st, rem), lambda st: st, state)
    return state


@functools.partial(jax.jit, static_argnames=("p", "smoothing", "comm_k",
                                             "mesh", "lambda1", "lambda2"))
def _morph_chunked_jit(u0, ls0, p: CVParams, smoothing: int, comm_k: int,
                       mesh, lambda1, lambda2):
    vec = u0.ndim == 3
    H, W = u0.shape[:2]
    s = int(smoothing)
    D = _reach("acwe", s) * comm_k
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    _check_geom(H, W, nx, ny, D)
    n_pix = jnp.asarray(H * W, ls0.dtype)
    from ..models.morph import _lambdas
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)

    def local_fn(u0_loc, ls_loc):
        # u0_loc: (h, w) gray or (C, h, w) channels-first (batched halo
        # exchange rides one ppermute per direction for all channels)
        if vec:
            u0p = exchange_halo2d_batched(u0_loc, D)      # (C, hp, wp)
        else:
            u0p = exchange_halo2d(u0_loc, D)
        sum_u = lax.psum(jnp.sum(u0_loc, axis=(-2, -1)), ("x", "y"))

        def means(ls):
            """Frozen per-chunk region means: ONE psum pair."""
            n_in = lax.psum(jnp.sum(ls), ("x", "y"))
            w_ = ls[None] if vec else ls
            s_in = lax.psum(jnp.sum(u0_loc * w_, axis=(-2, -1)),
                            ("x", "y"))
            c_in = s_in / (n_in + _TINY)
            c_out = (sum_u - s_in) / (n_pix - n_in + _TINY)
            return c_in, c_out

        def run_chunk(state, size):
            ls, n, _, streak = state
            c_in, c_out = means(ls)
            # frozen force plane on the PADDED block (chunk invariant)
            if vec:
                ci = c_in[:, None, None]
                co = c_out[:, None, None]
                l1b = jnp.asarray(l1, ls.dtype)[:, None, None]
                l2b = jnp.asarray(l2, ls.dtype)[:, None, None]
                fp = jnp.sum(l1b * (u0p - ci) ** 2
                             - l2b * (u0p - co) ** 2, axis=0)
            else:
                fp = l1 * (u0p - c_in) ** 2 - l2 * (u0p - c_out) ** 2
            lsp = exchange_halo2d(ls, D)
            one = jnp.ones((), ls.dtype)
            zero = jnp.zeros((), ls.dtype)
            for j in range(size):
                lsp = _refresh_global_pads(lsp, D)
                gx = shift_down(lsp) - shift_up(lsp)
                gy = shift_right(lsp) - shift_left(lsp)
                aux = (jnp.abs(gx) + jnp.abs(gy)) * fp
                lsp = jnp.where(aux < 0, one,
                                jnp.where(aux > 0, zero, lsp))
                lsp = _smooth_padded(lsp, (n + j) * s, s, D)
            ls_new = lsp[D:-D, D:-D]
            flips = lax.psum(jnp.sum((ls_new != ls).astype(ls.dtype)),
                             ("x", "y")) / n_pix
            # NaN-poison via the frozen force (non-finite image/means
            # must abort, not freeze the binary state at 0 flips)
            flips = flips + 0.0 * jnp.sum(fp[:1, :1])
            streak = jnp.where(flips < p.tol, streak + size, 0)
            return (ls_new, n + size, flips, streak)

        ls, iters, delta, _ = _chunk_loop(p, comm_k, run_chunk, ls_loc,
                                          ls_loc.dtype)
        c1, c2 = means(ls)
        return ls, iters, delta, c1, c2

    u_spec = P(None, "x", "y") if vec else P("x", "y")
    mapped = shard_map(local_fn, mesh=mesh,
                       in_specs=(u_spec, P("x", "y")),
                       out_specs=(P("x", "y"), P(), P(), P(), P()),
                       check_vma=False)
    u0_cf = jnp.transpose(u0, (2, 0, 1)) if vec else u0
    return mapped(u0_cf, ls0)


def segment_morph_sharded_chunked(u0, p: CVParams = CVParams(),
                                  mesh=None,
                                  ls0: Optional[jax.Array] = None,
                                  smoothing: int = 1,
                                  comm_k: int = 8,
                                  lambda1=None, lambda2=None):
    """Communication-avoiding sharded MorphACWE: one deep halo exchange
    + one psum pair per comm_k iterations (module docstring). Frozen-
    means-per-chunk trajectory class; comm_k=1 reproduces the published
    per-iteration scheme bitwise. Prefer even comm_k so period-2 limit
    cycles read as converged."""
    from ..models.morph import MorphResult, _init_ls

    if mesh is None:
        raise ValueError("segment_morph_sharded_chunked needs a mesh")
    img_spec = P("x", "y", None) if u0.ndim == 3 else P("x", "y")
    u0s = jax.device_put(u0, NamedSharding(mesh, img_spec))
    lss = jax.device_put(_init_ls(u0, p, ls0),
                         NamedSharding(mesh, P("x", "y")))
    with jax.set_mesh(mesh):
        ls, iters, delta, c1, c2 = _morph_chunked_jit(
            u0s, lss, p, int(smoothing), int(comm_k), mesh,
            lambda1, lambda2)
    return MorphResult(ls, ls >= 0.5, iters, delta, c1, c2)


@functools.partial(jax.jit, static_argnames=("p", "smoothing", "comm_k",
                                             "mesh", "balloon",
                                             "threshold"))
def _gac_chunked_jit(g, ls0, p: CVParams, smoothing: int, comm_k: int,
                     mesh, balloon: int, threshold: float):
    H, W = g.shape
    s = int(smoothing)
    b = int(balloon)
    D = _reach("gac", s) * comm_k
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    _check_geom(H, W, nx, ny, D)
    n_pix = jnp.asarray(H * W, ls0.dtype)

    def local_fn(g_loc, ls_loc):
        # loop invariants from the padded edge map: gradients + balloon
        # mask (replica-clamped central differences on the padded block
        # == the unsharded _prep at every owned + valid-halo cell)
        gp = exchange_halo2d(g_loc, D)
        dgx = 0.5 * (shift_down(gp) - shift_up(gp))
        dgy = 0.5 * (shift_right(gp) - shift_left(gp))
        if b:
            mask = (gp > threshold / abs(float(b))).astype(gp.dtype)
        else:
            mask = jnp.zeros_like(gp)
        # g is a run invariant: poison once (models/morph_gac.py)
        poison = 0.0 * jnp.sum(g_loc)

        def run_chunk(state, size):
            ls, n, _, streak = state
            lsp = exchange_halo2d(ls, D)
            one = jnp.ones((), ls.dtype)
            zero = jnp.zeros((), ls.dtype)
            for j in range(size):
                # ops/morph.gac_step inlined with a pad refresh before
                # each elementary stencil op (module docstring)
                if b:
                    lsp = _refresh_global_pads(lsp, D)
                    grown = dilate8(lsp) if b > 0 else erode8(lsp)
                    lsp = jnp.where(mask > 0, grown, lsp)
                lsp = _refresh_global_pads(lsp, D)
                dux = 0.5 * (shift_down(lsp) - shift_up(lsp))
                duy = 0.5 * (shift_right(lsp) - shift_left(lsp))
                aux = dgx * dux + dgy * duy
                lsp = jnp.where(aux > 0, one,
                                jnp.where(aux < 0, zero, lsp))
                lsp = _smooth_padded(lsp, (n + j) * s, s, D)
            ls_new = lsp[D:-D, D:-D]
            flips = lax.psum(jnp.sum((ls_new != ls).astype(ls.dtype)),
                             ("x", "y")) / n_pix + poison
            streak = jnp.where(flips < p.tol, streak + size, 0)
            return (ls_new, n + size, flips, streak)

        ls, iters, delta, _ = _chunk_loop(p, comm_k, run_chunk, ls_loc,
                                          ls_loc.dtype)
        return ls, iters, delta

    mapped = shard_map(local_fn, mesh=mesh,
                       in_specs=(P("x", "y"), P("x", "y")),
                       out_specs=(P("x", "y"), P(), P()),
                       check_vma=False)
    return mapped(g, ls0)


def segment_gac_sharded_chunked(g, p: CVParams = CVParams(), mesh=None,
                                ls0: Optional[jax.Array] = None,
                                smoothing: int = 1,
                                balloon: int = 0,
                                threshold: float = 0.5,
                                comm_k: int = 8):
    """Communication-avoiding sharded MorphGAC: one deep halo exchange
    per comm_k iterations and NOT ONE collective in the iteration body -
    trajectory-EXACT vs the per-iteration GSPMD path for any comm_k
    (the GAC loop has no reductions; module docstring). Prefer even
    comm_k so period-2 limit cycles read as converged."""
    from ..models.morph_gac import GACResult, _init_ls

    if mesh is None:
        raise ValueError("segment_gac_sharded_chunked needs a mesh")
    gs = jax.device_put(g, NamedSharding(mesh, P("x", "y")))
    lss = jax.device_put(_init_ls(g, p, ls0),
                         NamedSharding(mesh, P("x", "y")))
    with jax.set_mesh(mesh):
        ls, iters, delta = _gac_chunked_jit(
            gs, lss, p, int(smoothing), int(comm_k), mesh,
            int(balloon), float(threshold))
    return GACResult(ls, ls >= 0.5, iters, delta)
