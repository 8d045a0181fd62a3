"""Device-mesh utilities (SURVEY.md §2.9 comm backend).

The framework's communication layer is XLA collectives (NCCL between the
GPUs of a host), surfaced as `jax.shard_map` + `ppermute` (halo
exchange), `psum` (scalar reductions) and sharding annotations
(data-parallel batch placement). The code manages no communicator of its
own: the mesh IS the backend.

Axis conventions:
  'x'    - image rows    (spatial sharding, SP/TP analog)
  'y'    - image cols
  'data' - batch axis    (DP)
"""

from __future__ import annotations


import jax
from typing import Optional, Sequence

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_grid_mesh(nx: int, ny: int, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """2D (x, y) mesh for spatial sharding of one image (SURVEY.md §3.4),
    laid row-major over the device order. The cards of one host are
    joined all to all, so the shape follows the image alone."""
    devices = list(devices) if devices is not None else jax.devices()
    if nx * ny > len(devices):
        raise ValueError(f"mesh {nx}x{ny} needs {nx * ny} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[: nx * ny]).reshape(nx, ny)
    return Mesh(arr, ("x", "y"))


def make_data_mesh(n: Optional[int] = None, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """1D 'data' mesh for batched stacks (SURVEY.md §3.5)."""
    devices = list(devices) if devices is not None else jax.devices()
    n = n or len(devices)
    return Mesh(np.asarray(devices[:n]), ("data",))


def make_hybrid_mesh(ndata: int, nx: int, ny: int,
                     devices: Optional[Sequence] = None) -> Mesh:
    """(data, x, y) mesh: batches of spatially-sharded images."""
    devices = list(devices) if devices is not None else jax.devices()
    need = ndata * nx * ny
    if need > len(devices):
        raise ValueError(f"mesh needs {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(ndata, nx, ny)
    return Mesh(arr, ("data", "x", "y"))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("x", "y"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))
