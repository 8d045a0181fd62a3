#!/usr/bin/env python
"""Evaluation-config benchmark suite (BASELINE.json:6-12) on the GPU(s).

Runs the five eval configs through their public drivers and prints one
JSON line per config, each naming the device. Config 4 runs the sharded
comm_k chunk machinery on a (2, n/2) mesh over the available cards (a
1x1 mesh on one card) and config 5 runs over a data mesh of every card.
Fails without a GPU.

Usage: python bench_configs.py [--quick]
"""

import argparse
import json
import sys
import time

import numpy as np


def _t(run, *args, reps=3):
    """Best wall time of ``run(*args, r)`` over ``reps`` calls after a
    warm-up call that compiles. ``r`` perturbs the input inside the
    program, so no call can reuse an earlier result; each call ends in
    block_until_ready."""
    import jax
    import jax.numpy as jnp

    jax.block_until_ready(run(*args, jnp.float32(0)))
    best = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args, jnp.float32(rep + 1)))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller iteration counts")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_configs: needs an NVIDIA GPU, JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    from chan_vese.compile_cache import enable_compile_cache
    from chan_vese.models.multiphase import segment_multiphase
    from chan_vese.models.scalar import segment, segment_fixed
    from chan_vese.models.vector import segment_vector_fixed
    from chan_vese.params import CVParams

    from bench import card_info

    enable_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count(), "card": card_info()}
    rng = np.random.default_rng(0)
    p = CVParams()
    iters = 20 if args.quick else 100
    iters_small = 40 if args.quick else 1000

    def report(name, pixels, it, secs):
        rec = {"config": name, "Mpixel_iters_per_s": pixels * it / secs / 1e6,
               "iters": it, "wall_s": secs, "device": device}
        print(json.dumps(rec), flush=True)

    # config 1: 256x256 grayscale, checkerboard
    u = jnp.asarray(rng.uniform(0, 255, (256, 256)), jnp.float32)
    secs = _t(jax.jit(
        lambda u, r: segment_fixed(u + r, p, iters=iters_small).phi[0, 0]),
        u)
    report("1: gray 256^2 checkerboard", 256 * 256, iters_small, secs)

    # config 2: 512x512 RGB, per-channel lambdas
    u = jnp.asarray(rng.uniform(0, 255, (512, 512, 3)), jnp.float32)
    secs = _t(jax.jit(
        lambda u, r: segment_vector_fixed(
            u + r, p, iters=iters_small, lambda1=(1.0, 1.2, 0.8),
            lambda2=(1.0, 1.0, 1.0)).phi[0, 0]), u)
    report("2: RGB 512^2 per-channel lambda", 512 * 512, iters_small, secs)

    # config 3: multiphase 512^2, 2 level sets, the production loop
    # (segment_multiphase_fixed's per-iteration energy trace is a
    # diagnostic that costs as much as the iteration itself)
    u = jnp.asarray(rng.uniform(0, 255, (512, 512)), jnp.float32)
    secs = _t(jax.jit(
        lambda u, r: segment_multiphase(
            u + r, p, m_sets=2, fixed=True,
            max_iter=iters_small).phis[0, 0, 0]), u)
    report("3: multiphase 512^2 (2 phis)", 512 * 512, iters_small, secs)

    # config 4: single 4K, 2D-sharded grid + halo exchange, in
    # communication-avoiding comm_k=8 chunks (one 32-deep exchange and
    # one psum per 8 iterations). The image and phi0 are placed on the
    # mesh first, so the measurement is the solver, not the transfer.
    from jax.sharding import NamedSharding, PartitionSpec as P
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded, _make_phi0
    n = jax.device_count()
    nx = 2 if n >= 2 else 1
    ny = max(1, min(4, n // nx))
    mesh = make_grid_mesh(nx, ny)
    u = jnp.asarray(rng.uniform(0, 255, (2160, 3840)), jnp.float32)
    u = jax.device_put(u, NamedSharding(mesh, P("x", "y")))
    phi0 = _make_phi0(u.shape, p.init, u.dtype, mesh)
    for k, tag in ((8, "comm_k=8 chunks"), (1, "per-iteration halos")):
        with jax.set_mesh(mesh):  # outer-jitted segment_sharded contract
            secs = _t(jax.jit(
                lambda u, phi0, r, k=k: segment_sharded(
                    u + r, p, mesh, phi0=phi0, max_iter=iters, fixed=True,
                    comm_k=k).phi[0, 0]), u, phi0)
        report(f"4{'' if k > 1 else 'a'}: 4K sharded {nx}x{ny} mesh, {tag}",
               2160 * 3840, iters, secs)

    # config 4b: single-card 4K (the headline program, for comparison)
    u_single = jax.device_put(np.asarray(u), jax.devices()[0])
    pb = p.replace(tol=-1.0, max_iter=iters)
    secs = _t(jax.jit(lambda u, r: segment(u + r, pb).phi[0, 0]), u_single)
    report("4b: 4K single card", 2160 * 3840, iters, secs)

    # config 5: 256 frames of 512^2 via vmap over the data mesh
    from chan_vese.parallel.mesh import make_data_mesh
    from chan_vese.parallel.data_parallel import segment_stack_sharded
    frames = 32 if args.quick else 256
    it5 = 10 if args.quick else 30
    dmesh = make_data_mesh()
    stack = jnp.asarray(rng.uniform(0, 255, (frames, 512, 512)), jnp.float32)
    with jax.set_mesh(dmesh):
        secs = _t(jax.jit(
            lambda s, r: segment_stack_sharded(s + r, p, dmesh,
                                               iters=it5)[0][0, 0, 0]),
                  stack)
    report(f"5: stack {frames}x512^2 vmap+data-mesh", frames * 512 * 512,
           it5, secs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
