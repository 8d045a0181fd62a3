"""Halo exchange over the device mesh (SURVEY.md §2.9: the ring/neighbor
communication pattern of this workload; §3.4 call stack).

`exchange_halo2d` runs INSIDE `jax.shard_map`: each device contributes its
boundary strips to its N/S/E/W mesh neighbors via `jax.lax.ppermute`
(lowered to NCCL sends between GPUs). Corners arrive for free by the
two-stage trick: exchange row strips first, then exchange column strips of
the row-EXTENDED array - the column strips then carry the neighbor's halo
rows, i.e. the diagonal device's corner cells.

Devices at the global boundary receive zeros from ppermute (no source);
those halos are overwritten with edge-replicates of the device's own
boundary - exactly the clamped-index Neumann convention of the solver
(ops/numerics.py), so sharded stencils see the same values an unsharded
run would.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _shift_perm(n: int, up: bool):
    """Perm pairs delivering data toward higher (up=False) / lower index."""
    if up:
        return [(i, i - 1) for i in range(1, n)]
    return [(i, i + 1) for i in range(n - 1)]


def exchange_halo2d_batched(x, depth: int, axes=("x", "y")):
    """(..., h, w) -> (..., h + 2*depth, w + 2*depth): the 2D halo
    exchange on every leading-dim slice with ONE ppermute per direction
    (strips of all slices ride the same collective - the collective
    count of the plain 2D exchange, batched data).

    Used by the sharded multichannel morphological chunks
    (parallel/sharded_morph.py), whose channels-first image exchanges
    all channels in one collective per direction.
    """
    ax_r, ax_c = axes
    nx = lax.axis_size(ax_r)
    ny = lax.axis_size(ax_c)
    ix = lax.axis_index(ax_r)
    iy = lax.axis_index(ax_c)

    from_north = lax.ppermute(x[..., -depth:, :], ax_r,
                              _shift_perm(nx, up=False))
    from_south = lax.ppermute(x[..., :depth, :], ax_r,
                              _shift_perm(nx, up=True))
    top_rep = jnp.broadcast_to(x[..., :1, :], from_north.shape)
    bot_rep = jnp.broadcast_to(x[..., -1:, :], from_south.shape)
    top = jnp.where(ix == 0, top_rep, from_north)
    bot = jnp.where(ix == nx - 1, bot_rep, from_south)
    xr = jnp.concatenate([top, x, bot], axis=-2)

    from_west = lax.ppermute(xr[..., :, -depth:], ax_c,
                             _shift_perm(ny, up=False))
    from_east = lax.ppermute(xr[..., :, :depth], ax_c,
                             _shift_perm(ny, up=True))
    left_rep = jnp.broadcast_to(xr[..., :, :1], from_west.shape)
    right_rep = jnp.broadcast_to(xr[..., :, -1:], from_east.shape)
    left = jnp.where(iy == 0, left_rep, from_west)
    right = jnp.where(iy == ny - 1, right_rep, from_east)
    return jnp.concatenate([left, xr, right], axis=-1)


def exchange_halo2d(x, depth: int = 4, axes=("x", "y")):
    """Pad a local (h, w) block to (h + 2*depth, w + 2*depth) with halos.

    Must be called inside shard_map over a mesh with the given axes. Works
    for any depth <= min(h, w).
    """
    ax_r, ax_c = axes
    nx = lax.axis_size(ax_r)
    ny = lax.axis_size(ax_c)
    ix = lax.axis_index(ax_r)
    iy = lax.axis_index(ax_c)

    # --- rows ---------------------------------------------------------
    # halo above me = south-most rows of my north neighbor (sent downward)
    from_north = lax.ppermute(x[-depth:, :], ax_r, _shift_perm(nx, up=False))
    from_south = lax.ppermute(x[:depth, :], ax_r, _shift_perm(nx, up=True))
    top_rep = jnp.broadcast_to(x[:1, :], (depth, x.shape[1]))
    bot_rep = jnp.broadcast_to(x[-1:, :], (depth, x.shape[1]))
    top = jnp.where(ix == 0, top_rep, from_north)
    bot = jnp.where(ix == nx - 1, bot_rep, from_south)
    xr = jnp.concatenate([top, x, bot], axis=0)

    # --- cols (of the row-extended array: corners ride along) ----------
    from_west = lax.ppermute(xr[:, -depth:], ax_c, _shift_perm(ny, up=False))
    from_east = lax.ppermute(xr[:, :depth], ax_c, _shift_perm(ny, up=True))
    left_rep = jnp.broadcast_to(xr[:, :1], (xr.shape[0], depth))
    right_rep = jnp.broadcast_to(xr[:, -1:], (xr.shape[0], depth))
    left = jnp.where(iy == 0, left_rep, from_west)
    right = jnp.where(iy == ny - 1, right_rep, from_east)
    return jnp.concatenate([left, xr, right], axis=1)
