"""Data-parallel batched segmentation over a device mesh (SURVEY.md §3.5,
eval config 5: 256 frames of 512x512 across the mesh's devices).

Data parallelism for this workload: the vmap'd solver
(models/batched.py) is a single jitted program over (N, H, W); placing the
batch with a NamedSharding over the mesh's 'data' axis makes XLA partition
it - each device segments its frames independently, no halos, no
collectives in the hot loop (convergence in tol mode uses one psum-free
per-frame while_loop under vmap).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.batched import segment_batch, segment_stack_fixed
from ..params import CVParams


def shard_stack(u0, mesh: Mesh):
    """Place a (N, H, W[, C]) stack over the mesh's 'data' axis."""
    n = u0.shape[0]
    nd = mesh.shape["data"]
    if n % nd:
        raise ValueError(f"batch {n} not divisible by data axis {nd}")
    return jax.device_put(u0, NamedSharding(mesh, P("data")))


def segment_stack_sharded(u0, p: CVParams = CVParams(), mesh: Mesh = None,
                          iters: Optional[int] = None):
    """Segment a frame stack data-parallel across the mesh.

    iters=None -> tolerance mode (per-frame iteration counts); otherwise
    the lean fixed-iteration loop. Outputs inherit the input sharding.
    """
    if mesh is None:
        raise ValueError("segment_stack_sharded needs a mesh "
                         "(parallel.mesh.make_data_mesh)")
    u0 = shard_stack(u0, mesh)
    # Under an outer jit trace set_mesh is forbidden - the CALLER must
    # hold `with jax.set_mesh(mesh):` open around the jitted call (same
    # contract as segment_sharded; bench_configs' single-dispatch
    # timing relies on it).
    mesh_ctx = (contextlib.nullcontext() if isinstance(u0, jax.core.Tracer)
                else jax.set_mesh(mesh))
    with mesh_ctx:
        if iters is None:
            return segment_batch(u0, p)
        return segment_stack_fixed(u0, p, iters=iters)
