#!/usr/bin/env python
"""Per-family benchmark: one JSON line per model family on the GPU.

One steady-state throughput row per FAMILY at a fixed representative
config, so a regression in any family shows up:

    scalar           4K gray, the tolerance driver run for a fixed count
    vector           4K RGB, the same driver
    multiphase       512^2, M = 2, the production loop
    batched-stack    64 x 512^2 over the data mesh
    morph-acwe       4K gray, lean iterations driver
    morph-gac        4K gray, lean iterations driver
    pyramid          4K gray circle-init time-to-converged-mask (ms,
                     lower is better - the one latency-metric row)

Every row names the device. Fails without a GPU.

Usage: python bench_families.py [--quick] [name-substring ...]
"""

import argparse
import json
import sys
import time

import numpy as np

from bench_configs import _t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("only", nargs="*", default=[])
    args = ap.parse_args()
    only = [s.lower() for s in args.only]

    def want(name):
        return not only or any(s in name.lower() for s in only)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_families: needs an NVIDIA GPU, JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    from chan_vese.compile_cache import enable_compile_cache
    from chan_vese.params import CVParams

    from bench import card_info

    enable_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count(), "card": card_info()}
    rng = np.random.default_rng(0)
    p = CVParams()
    iters = 100 if args.quick else 800
    iters_small = 200 if args.quick else 1000

    def report(name, label, pixels, it, secs):
        rec = {"family": name, "label": label,
               "mpix_iters_per_s": pixels * it / secs / 1e6,
               "iters": it, "seconds": secs, "device": device}
        print(json.dumps(rec), flush=True)

    u4k = jnp.asarray(rng.uniform(0, 255, (2160, 3840)), jnp.float32)
    u4k_rgb = jnp.asarray(rng.uniform(0, 255, (2160, 3840, 3)),
                          jnp.float32)
    u512 = jnp.asarray(rng.uniform(0, 255, (512, 512)), jnp.float32)

    if want("scalar"):
        from chan_vese.models.scalar import segment

        ps = p.replace(tol=-1.0, max_iter=iters)

        @jax.jit
        def run_s(u, r):
            return segment(u + r, ps).phi[0, 0]

        t = _t(run_s, u4k)
        report("scalar", "4K gray tolerance driver, fixed count",
               u4k.size, iters, t)

    if want("vector"):
        from chan_vese.models.scalar import segment

        ps = p.replace(tol=-1.0, max_iter=iters)

        @jax.jit
        def run_v(u, r):
            return segment(u + r, ps).phi[0, 0]

        t = _t(run_v, u4k_rgb)
        report("vector", "4K RGB tolerance driver, fixed count",
               2160 * 3840, iters, t)

    if want("multiphase"):
        # segment_multiphase(fixed=True) = the production loop;
        # segment_multiphase_fixed is the TRACE twin whose per-iteration
        # energy diagnostic costs as much as the iteration
        from chan_vese.models.multiphase import segment_multiphase

        @jax.jit
        def run_mp(u, r):
            res = segment_multiphase(u + r, p, m_sets=2, fixed=True,
                                     max_iter=iters_small)
            return res.phis[0, 0, 0]

        t = _t(run_mp, u512)
        report("multiphase", "512^2 M=2 (production loop)",
               u512.size, iters_small, t)

    if want("batched-stack"):
        from chan_vese.parallel.data_parallel import \
            segment_stack_sharded
        from chan_vese.parallel.mesh import make_data_mesh

        stack = jnp.asarray(rng.uniform(0, 255, (64, 512, 512)),
                            jnp.float32)
        it_b = 10 if args.quick else 30
        dmesh = make_data_mesh()
        with jax.set_mesh(dmesh):
            t = _t(jax.jit(
                lambda s, r: segment_stack_sharded(
                    s + r, p, dmesh, iters=it_b)[0][0, 0, 0]), stack)
        report("batched-stack", "64x512^2 stack over the data mesh",
               stack.size, it_b, t)

    if want("morph-acwe"):
        from chan_vese.models.morph import segment_morph_iterations

        @jax.jit
        def run_ma(u, r):
            res = segment_morph_iterations(u + r, p, iters=iters,
                                           smoothing=1)
            return res.ls[0, 0]

        t = _t(run_ma, u4k)
        report("morph-acwe", "4K gray lean driver",
               u4k.size, iters, t)

    if want("morph-gac"):
        from chan_vese.models.morph_gac import segment_gac_iterations

        g = jnp.asarray(rng.uniform(0.05, 1.0, (2160, 3840)), jnp.float32)

        @jax.jit
        def run_mg(gg, r):
            res = segment_gac_iterations(gg + 1e-6 * r, p, iters=iters,
                                         smoothing=1, balloon=1,
                                         threshold=0.3)
            return res.ls[0, 0]

        t = _t(run_mg, g)
        report("morph-gac", "4K gray lean driver",
               g.size, iters, t)

    if want("pyramid"):
        # time-to-converged-mask (wall clock incl. per-level dispatches).
        # Not a throughput row: milliseconds, lower is better.
        from chan_vese.models.pyramid import segment_pyramid

        yy, xx = np.mgrid[:2160, :3840]
        disk = ((yy - 1080.0) ** 2 + (xx - 1920.0) ** 2
                < 800.0 ** 2)
        img = jnp.asarray(np.where(disk, 200.0, 0.0)
                          + rng.normal(0, 5, (2160, 3840)), jnp.float32)
        pp = CVParams(init="circle", tol=1e-4, patience=4, min_iter=4)
        segment_pyramid(img, pp).mask.block_until_ready()  # warm
        t0 = time.perf_counter()
        res = segment_pyramid(img, pp)
        res.mask.block_until_ready()
        t = time.perf_counter() - t0
        rec = {"family": "pyramid",
               "label": "4K circle-init time-to-converged-mask",
               "ms": t * 1e3, "level_iters": list(res.level_iters),
               "device": device}
        print(json.dumps(rec), flush=True)

    return 0


if __name__ == "__main__":
    sys.exit(main())
