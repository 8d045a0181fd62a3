"""Batched segmentation of image stacks (SURVEY.md §3.5; B:11).

Data parallelism: ``vmap`` vectorizes the whole solver over a leading
frame axis (one fused program working on (N, H, W) arrays), and the same
jitted function runs sharded across a device mesh's 'data' axis by
placing the batch with a NamedSharding (parallel/data_parallel.py) - XLA
partitions the program with zero code changes here; there are no halos
because every frame lives whole on one device.

Convergence in batch mode: frames converge at different iterations; under
vmap the while_loop runs until ALL frames converge (converged frames keep
sweeping but their flip fraction is 0, so results are unchanged... note
phi itself keeps drifting harmlessly). For throughput work prefer
``segment_stack_fixed`` (the B:11 eval config runs fixed iterations).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..params import CVParams
from .scalar import SegResult, segment, step
from ..utils.init_phi import init_phi


@functools.partial(jax.jit, static_argnames=("p", "lambda1", "lambda2"))
def segment_batch(u0, p: CVParams = CVParams(),
                  phi0: Optional[jax.Array] = None,
                  lambda1=None, lambda2=None) -> SegResult:
    """Tolerance-mode segmentation of a stack (N, H, W[, C]).

    Returns a SegResult with a leading batch axis on every field
    (per-frame iters/delta/c1/c2).
    """
    fn = lambda u, ph: segment(u, p, ph, lambda1=lambda1, lambda2=lambda2)
    if phi0 is None:
        phi0 = init_phi(u0.shape[1:3], p.init, u0.dtype)
        phi0 = jnp.broadcast_to(phi0, u0.shape[:3])
    return jax.vmap(fn)(u0, phi0)


@functools.partial(jax.jit,
                   static_argnames=("p", "iters", "lambda1", "lambda2"))
def segment_stack_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                        phi0: Optional[jax.Array] = None,
                        lambda1=None, lambda2=None):
    """Fixed-iteration batch segmentation (the B:11 throughput config).

    Lean hot loop: no per-iteration energy logging, one scan carrying the
    full (N, H, W) phi stack. Returns (phi, mask).
    """
    if phi0 is None:
        phi0 = init_phi(u0.shape[1:3], p.init, u0.dtype)
        phi0 = jnp.broadcast_to(phi0, u0.shape[:3])

    from ..ops.reinit import maybe_reinit

    one = lambda u, ph: step(ph, u, p, lambda1, lambda2)[0]

    def body(carry, _):
        phis, n = carry
        phis = jax.vmap(one)(u0, phis)
        if p.reinit_every:
            phis = jax.vmap(lambda ph: maybe_reinit(ph, n, p))(phis)
        return (phis, n + 1), None

    (phis, _), _ = jax.lax.scan(body, (phi0, jnp.int32(0)), None,
                                length=iters)
    return phis, phis >= 0
