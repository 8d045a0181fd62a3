"""Multi-host entry (SURVEY.md §5 'comm backend': multi-host via
jax.distributed.initialize).

On a multi-host cluster every host runs the same program;
``initialize()`` wires the JAX distributed runtime, after which
``jax.devices()`` spans every host's devices and the mesh constructors in
parallel/mesh.py and the shard_map solvers work unchanged - inputs must
be placed per-host with ``jax.make_array_from_process_local_data``
(wrapped below). GPU hosts discover no coordinator on their own: pass
``coordinator_address`` (host:port), ``num_processes`` and
``process_id`` explicitly.

Single-process environments (the dev box, CI) are no-ops throughout, so
library code can call these unconditionally.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the distributed runtime (no-op if single process or
    already initialized)."""
    if jax.process_count() > 1:
        return  # already initialized
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (ValueError, RuntimeError):
        # single-process / already-initialized environments
        pass


def global_array(local_data, sharding):
    """Assemble a global sharded array from per-process local data."""
    return jax.make_array_from_process_local_data(sharding, local_data)


def is_coordinator() -> bool:
    return jax.process_index() == 0
