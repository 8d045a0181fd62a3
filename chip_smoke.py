#!/usr/bin/env python
"""Smoke test on NVIDIA GPUs: every segmentation family through its public
entry point, compiled by XLA for the card, checked against CPU runs.

    python chip_smoke.py          # one card: phases 1-4 below
    python chip_smoke.py --four   # four cards: the sharded paths only

Phases on one card:
  1. the CLI's main path at 4K (3840x2160, circle init, tolerance mode);
  2. 4K parity: GPU float32 against the host CPU in float64;
  3. each other family at its BASELINE.json size, against the CPU run of
     the same call at a short iteration count;
  4. the tests marked ``gpu``, in this process.

Everything runs in ONE process: a second JAX process would find most of
the card's memory already reserved. The script exits non-zero, and prints
no final line, without a GPU, outside a checkout of this repository, or
when any check fails. Its last line of standard output is one JSON object
naming the device.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

H4K, W4K = 2160, 3840

# Tolerances, each with its reason (CHANGES.md repeats them):
# f32 (GPU) against f64 (CPU), 100 iterations at 4K from the circle init:
# the per-reduction f32 error is ~3e-6 relative (tests/test_f32_accuracy),
# and the circle-init trajectory does not amplify it (measured 2.3e-6 on
# the means and 3.3e-6 on the energy at 540x960 on the CPU), so the
# means and the energy must agree to the BASELINE.json energy criterion.
REL_MEANS_ENERGY = 1e-5
# A contour pixel whose f32 and f64 phi straddle zero flips its mask bit:
# allow one such pixel in 10^5.
MASK_FRACTION = 1e-5
# f32 summation noise can lift a settled energy by a few ulps per
# iteration; a real increase is orders of magnitude larger.
ENERGY_RISE_F32 = 1e-6
# GPU f32 against CPU f32 of the same call: the two backends sum in
# another order and fuse differently. phi itself is not compared: where
# it is flat, far from the contour, the curvature weights mu/|grad phi|
# are large and last-bit differences grow about tenfold every three
# iterations without moving the contour (measured on the CPU, f32 vs f64
# at 256^2 from the checkerboard init: phi differs by 16% of max|phi|
# after 10 iterations while the masks are identical). The masks and the
# region means are compared instead; the means agreed to 2.3e-5 (gray)
# and 3.0e-5 (RGB) at 10 iterations in that measurement.
MEANS_F32 = 1e-3
MASK_F32 = 1e-3
# The stored goldens are f64 C runs; the f32 wavefront run of the same
# fixture drifts to ~5e-4 relative over 60 sweeps (measured on the CPU).
GOLDEN_REL_F32 = 2e-3
# The converged mask of the 4K two-disk image against its ground truth.
MIN_IOU = 0.99


class SmokeFailure(Exception):
    pass


def check(name, ok, detail):
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        raise SmokeFailure(f"{name}: {detail}")


def iou(a, b):
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 1.0


def max_rel(got, want):
    """Largest elementwise |got - want| / |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), 1e-30)))


def mask_mismatch(a, b):
    """Fraction of pixels whose mask bits differ."""
    return float(np.mean(np.asarray(a, bool) != np.asarray(b, bool)))


def max_energy_rise(energy):
    """Largest relative increase between consecutive energies (<= 0
    when the trace is non-increasing)."""
    e = np.asarray(energy, np.float64)
    return float(np.max(np.diff(e) / np.abs(e[:-1]))) if e.size > 1 \
        else 0.0


def two_disks(h, w, seed=0, noise=8.0):
    """Two bright disks (217) on a dark background (38) plus Gaussian
    noise, float32, and the ground-truth mask. Both disks straddle the
    default circle init (radius min(h, w)/4 about the center), so the
    tolerance-mode solve from that init converges to them."""
    i, j = np.mgrid[0:h, 0:w].astype(np.float32)
    gt = ((np.hypot(i - 0.38 * h, j - 0.36 * w) < 0.16 * h)
          | (np.hypot(i - 0.62 * h, j - 0.64 * w) < 0.16 * h))
    rng = np.random.default_rng(seed)
    img = np.where(gt, 217.0, 38.0) + noise * rng.standard_normal((h, w))
    return img.astype(np.float32), gt


def card_info():
    """The card's name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def timed(fn, *args, **kw):
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def cold_warm(fn, *args, **kw):
    """Run twice: the first call compiles, the second is steady state.
    Returns (result, cold seconds, warm seconds)."""
    _, cold = timed(fn, *args, **kw)
    out, warm = timed(fn, *args, **kw)
    return out, cold, warm


def phase_cli(workdir):
    """1. The main path at full width: the CLI on a 4K image."""
    from chan_vese import cli

    print("phase 1: CLI, 4K two disks, circle init, tolerance mode",
          flush=True)
    img, gt = two_disks(H4K, W4K)
    src = workdir / "disks_4k.npy"
    out = workdir / "mask_4k.npy"
    np.save(src, img)
    # the circle init must travel hundreds of pixels at 4K, so the run
    # needs a tighter tolerance and a higher cap than the CLI defaults
    argv = [str(src), "-o", str(out), "--init", "circle",
            "--tol", "1e-7", "--max-iter", "40000"]
    walls = []
    for _ in range(2):  # cold (compiles), then warm
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            rc = cli.main(argv)
        walls.append(time.perf_counter() - t0)
        check("CLI exit code", rc == 0, f"rc={rc}; log: {log.getvalue()}")
    m = re.search(r"converged in (\d+) iters", log.getvalue())
    check("CLI reported an iteration count", m is not None,
          log.getvalue().strip())
    iters = int(m.group(1))
    score = iou(np.load(out) > 127, gt)
    print(f"  iterations {iters}; wall cold {walls[0]:.3f} s (compile "
          f"included), warm {walls[1]:.3f} s, "
          f"{walls[1] / iters * 1e3:.4f} ms/iteration warm", flush=True)
    check("CLI converged before the cap", iters < 40000, f"{iters}")
    check(f"CLI mask IoU >= {MIN_IOU}", score >= MIN_IOU, f"{score:.6f}")


def phase_parity(gpu, cpu):
    """2. Parity at real width: 100 iterations, GPU f32 vs CPU f64."""
    import jax

    from chan_vese import CVParams, segment, segment_fixed

    print("phase 2: 4K parity, segment_fixed x100, GPU f32 vs CPU f64",
          flush=True)
    img, gt = two_disks(H4K, W4K)
    p = CVParams(init="circle")
    u32 = jax.device_put(img, gpu)
    t0 = time.perf_counter()
    compiled = segment_fixed.lower(u32, p, 100).compile()
    compile_s = time.perf_counter() - t0
    print(f"  compile {compile_s:.3f} s; memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)
    tr, run_s = timed(compiled, u32)
    print(f"  GPU run {run_s:.3f} s", flush=True)
    with jax.enable_x64(True):
        u64 = jax.device_put(img.astype(np.float64), cpu)
        ref, cpu_s = timed(segment_fixed, u64, p, 100)
    print(f"  CPU f64 run {cpu_s:.3f} s (compile included)", flush=True)
    for name, got, want in (("c1", tr.c1, ref.c1), ("c2", tr.c2, ref.c2),
                            ("energy", tr.energy, ref.energy)):
        err = max_rel(got, want)
        check(f"{name} trace rel err <= {REL_MEANS_ENERGY}",
              err <= REL_MEANS_ENERGY, f"{err:.3e}")
    mis = mask_mismatch(tr.mask, ref.mask)
    check(f"mask mismatch <= {MASK_FRACTION}", mis <= MASK_FRACTION,
          f"{mis:.3e} ({int(round(mis * img.size))} px)")
    rise64 = max_energy_rise(ref.energy)
    check("f64 energy non-increasing", rise64 <= 0.0, f"{rise64:.3e}")
    rise32 = max_energy_rise(tr.energy)
    check(f"f32 energy rise <= {ENERGY_RISE_F32}",
          rise32 <= ENERGY_RISE_F32, f"{rise32:.3e}")

    # steady-state rate of the production loop: the tolerance driver
    # with an unreachable tolerance runs exactly max_iter iterations
    n = 400
    pn = p.replace(tol=-1.0, max_iter=n)
    res, cold, warm = cold_warm(segment, u32, pn)
    check("fixed-count tolerance run length", int(res.iters) == n,
          f"{int(res.iters)}")
    rate = H4K * W4K * n / warm / 1e6
    print(f"  4K segment x{n}: cold {cold:.3f} s, warm {warm:.3f} s, "
          f"{rate:.1f} Mpixel-iters/s, {warm / n * 1e3:.4f} ms/iteration",
          flush=True)


def _family(name, gpu, cpu, run, n_full, n_short, compare):
    """Time ``run(device, iters)`` at full length on the GPU (cold and
    warm), then compare the GPU and CPU results at ``n_short``."""
    import jax

    out, cold, warm = cold_warm(run, gpu, n_full)
    # the arrays; scalar diagnostics such as the lean drivers' untracked
    # (NaN) flip fraction are not results
    fields = [x for x in jax.tree_util.tree_leaves(out) if np.ndim(x)]
    finite = all(bool(np.all(np.isfinite(np.asarray(x, np.float64))))
                 for x in fields)
    print(f"  {name}: {n_full} iterations, cold {cold:.3f} s, warm "
          f"{warm:.3f} s", flush=True)
    check(f"{name} finite", finite, "all outputs finite")
    got = run(gpu, n_short)
    want = run(cpu, n_short)
    compare(name, got, want)
    return out


def _cmp(name, mask_g, mask_c, means=(), mask_tol=MASK_F32,
         means_tol=MEANS_F32):
    """Masks (and region means, as (label, got, want) triples) of two
    runs of the same call."""
    mis = mask_mismatch(mask_g, mask_c)
    check(f"{name}: mask mismatch <= {mask_tol}", mis <= mask_tol,
          f"{mis:.3e}")
    for label, got, want in means:
        err = max_rel(got, want)
        check(f"{name}: {label} rel err <= {means_tol}", err <= means_tol,
              f"{err:.3e}")


def phase_families(gpu, cpu):
    """3. Each other family once at its BASELINE.json size."""
    import jax

    from chan_vese import (CVParams, segment_fixed, segment_multiphase,
                           segment_stack_fixed, segment_vector_fixed)
    from chan_vese.models.morph import segment_morph_iterations
    from chan_vese.models.morph_gac import segment_gac_iterations
    from chan_vese.models.pyramid import segment_pyramid
    from chan_vese.ops.morph import inverse_gaussian_gradient
    from chan_vese.utils.trace import read_energy_csv

    put = jax.device_put
    print("phase 3: families at BASELINE.json sizes", flush=True)
    p = CVParams()

    # config 1: 256^2 gray, checkerboard, 100 fixed iterations
    g256, _ = two_disks(256, 256, seed=1)
    _family("config 1 gray 256^2", gpu, cpu,
            lambda d, n: segment_fixed(put(g256, d), p, n), 100, 10,
            lambda nm, a, b: _cmp(nm, a.mask, b.mask,
                                  (("c1", a.c1, b.c1), ("c2", a.c2, b.c2))))
    # ... and the stored f64 goldens (goldens/README.md): the wavefront
    # (sequential Gauss-Seidel) schedule of the 64^2 golden fixture
    gold = Path(__file__).resolve().parent / "goldens"
    i, j = np.mgrid[0:64, 0:64].astype(np.float64)
    disks = ((np.hypot(i - 0.3 * 64, j - 0.3 * 64) < 0.15 * 64)
             | (np.hypot(i - 0.68 * 64, j - 0.65 * 64) < 0.2 * 64))
    fixture = np.where(disks, 217.0, 38.0) + 8.0 * np.random.default_rng(
        0).standard_normal((64, 64))
    for kind in ("checkerboard", "circle"):
        trg = segment_fixed(put(fixture.astype(np.float32), gpu),
                            CVParams(order="wavefront", init=kind), 60)
        ref = read_energy_csv(gold / f"config1_64_{kind}_f64.csv")
        err = max_rel(trg.energy, ref["energy"])
        check(f"config 1 golden ({kind}) energy rel err <= "
              f"{GOLDEN_REL_F32}", err <= GOLDEN_REL_F32, f"{err:.3e}")

    # config 2: 512^2 RGB with per-channel lambdas
    g512, _ = two_disks(512, 512, seed=2)
    rgb = np.stack([g512, 0.8 * g512 + 20.0, 255.0 - g512], axis=-1)
    lam1, lam2 = (1.0, 1.2, 0.8), (1.0, 0.9, 1.1)
    _family("config 2 RGB 512^2", gpu, cpu,
            lambda d, n: segment_vector_fixed(put(rgb, d), p, n,
                                              lambda1=lam1, lambda2=lam2),
            100, 10,
            lambda nm, a, b: _cmp(nm, a.mask, b.mask,
                                  (("c1", a.c1, b.c1), ("c2", a.c2, b.c2))))

    # config 3: multiphase M = 2 at 512^2
    yy, xx = np.mgrid[0:512, 0:512]
    labels = (yy >= 256).astype(int) * 2 + (xx >= 256)
    four = (np.array([13.0, 89.0, 166.0, 242.0])[labels]
            + 4.0 * np.random.default_rng(3).standard_normal((512, 512)))
    four = four.astype(np.float32)
    pm = CVParams(mu=0.003 * 255 ** 2)
    _family("config 3 multiphase 512^2", gpu, cpu,
            lambda d, n: segment_multiphase(put(four, d), pm, m_sets=2,
                                            fixed=True, max_iter=n),
            100, 10,
            lambda nm, a, b: _cmp(nm, a.labels, b.labels))

    # config 5: a stack of 256 frames of 512^2 (the CPU compares the
    # first 8 frames: frames are independent)
    stack = np.stack([two_disks(512, 512, seed=10 + k)[0]
                      for k in range(256)])

    def run_stack(d, n):
        s = stack if d is gpu else stack[:8]
        return segment_stack_fixed(put(s, d), p, n)

    _family("config 5 stack 256x512^2", gpu, cpu, run_stack, 100, 5,
            lambda nm, a, b: _cmp(nm, a[1][:8], b[1][:8]))

    # MorphACWE and MorphGAC at 4K (lean fixed-iteration drivers)
    img4k, gt4k = two_disks(H4K, W4K, seed=4)
    _family("MorphACWE 4K", gpu, cpu,
            lambda d, n: segment_morph_iterations(put(img4k, d), p, n),
            100, 10, lambda nm, a, b: _cmp(nm, a.mask, b.mask,
                                           mask_tol=MASK_FRACTION))
    edge = np.asarray(inverse_gaussian_gradient(put(img4k, cpu), 5.0, 2.0))
    _family("MorphGAC 4K", gpu, cpu,
            lambda d, n: segment_gac_iterations(put(edge, d), p, n,
                                                balloon=1, threshold=0.3),
            100, 10, lambda nm, a, b: _cmp(nm, a.mask, b.mask,
                                           mask_tol=MASK_FRACTION))

    # the coarse-to-fine pyramid at 4K, tolerance mode from the circle init
    pc = CVParams(init="circle")
    res, cold, warm = cold_warm(segment_pyramid, put(img4k, gpu), pc)
    score = iou(res.mask, gt4k)
    print(f"  pyramid 4K: level iterations {res.level_iters} (coarse to "
          f"fine), cold {cold:.3f} s, warm {warm:.3f} s", flush=True)
    check(f"pyramid 4K IoU >= {MIN_IOU}", score >= MIN_IOU, f"{score:.6f}")
    short = pc.replace(max_iter=3, tol=-1.0)
    a = segment_pyramid(put(img4k, gpu), short)
    b = segment_pyramid(put(img4k, cpu), short)
    _cmp("pyramid 4K (3 iterations per level)", a.mask, b.mask,
         (("c1", a.c1, b.c1), ("c2", a.c2, b.c2)))


def phase_gpu_tests():
    """4. The tests marked ``gpu``, in this process."""
    import pytest

    print("phase 4: tests marked gpu", flush=True)
    tests = Path(__file__).resolve().parent / "tests"
    rc = pytest.main([str(tests), "-q", "-m", "gpu", "-p",
                      "no:cacheprovider"])
    check("pytest -m gpu", rc == 0, f"exit code {int(rc)}")


def phase_four(devs):
    """5. Four cards: the 2x2 spatial mesh and the 4-card data mesh,
    each against the single-card result."""
    import jax

    from chan_vese import CVParams, segment_fixed, segment_stack_fixed
    from chan_vese.ops.reductions import region_means
    from chan_vese.parallel.data_parallel import segment_stack_sharded
    from chan_vese.parallel.mesh import make_data_mesh, make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    check("four GPUs", len(devs) >= 4, f"{len(devs)} devices")
    devs = devs[:4]
    print("phase 5: four cards", flush=True)
    img, _ = two_disks(H4K, W4K)
    p = CVParams(init="circle")
    n = 100
    mesh = make_grid_mesh(2, 2, devs)
    one = make_grid_mesh(1, 1, devs[:1])

    res, cold, warm = cold_warm(segment_sharded, img, p, mesh,
                                max_iter=n, fixed=True)
    check("2x2 result spans four devices",
          len(res.phi.sharding.device_set) == 4,
          f"{len(res.phi.sharding.device_set)}")
    u_one = jax.device_put(img, devs[0])
    ref, rcold, rwarm = cold_warm(segment_fixed, u_one, p, n)
    ref_c1, ref_c2 = region_means(u_one, ref.phi, p.eps)
    print(f"  4K x{n} comm_k=1: 2x2 cold {cold:.3f} s, warm {warm:.3f} s; "
          f"1 card cold {rcold:.3f} s, warm {rwarm:.3f} s", flush=True)
    _cmp("2x2 comm_k=1 vs single-card segment_fixed", res.mask, ref.mask,
         (("c1", res.c1, ref_c1), ("c2", res.c2, ref_c2)), MASK_FRACTION,
         REL_MEANS_ENERGY)

    res8, cold, warm = cold_warm(segment_sharded, img, p, mesh, max_iter=n,
                                 fixed=True, comm_k=8)
    ref8, rcold, rwarm = cold_warm(segment_sharded, img, p, one,
                                   max_iter=n, fixed=True, comm_k=8)
    check("2x2 comm_k=8 result spans four devices",
          len(res8.phi.sharding.device_set) == 4,
          f"{len(res8.phi.sharding.device_set)}")
    print(f"  4K x{n} comm_k=8: 2x2 cold {cold:.3f} s, warm {warm:.3f} s; "
          f"1x1 cold {rcold:.3f} s, warm {rwarm:.3f} s", flush=True)
    _cmp("2x2 comm_k=8 vs 1x1 comm_k=8", res8.mask, ref8.mask,
         (("c1", res8.c1, ref8.c1), ("c2", res8.c2, ref8.c2)),
         MASK_FRACTION, REL_MEANS_ENERGY)

    stack = np.stack([two_disks(512, 512, seed=10 + k)[0]
                      for k in range(256)])
    dmesh = make_data_mesh(4, devs)
    (phis, masks), cold, warm = cold_warm(segment_stack_sharded, stack, p,
                                          dmesh, iters=30)
    check("stack spans four devices", len(phis.sharding.device_set) == 4,
          f"{len(phis.sharding.device_set)}")
    (rphis, rmasks), rcold, rwarm = cold_warm(
        segment_stack_fixed, jax.device_put(stack, devs[0]), p, 30)
    print(f"  stack 256x512^2 x30: data mesh cold {cold:.3f} s, warm "
          f"{warm:.3f} s; 1 card cold {rcold:.3f} s, warm {rwarm:.3f} s",
          flush=True)
    _cmp("data mesh vs single-card segment_stack_fixed", masks, rmasks,
         mask_tol=MASK_FRACTION)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    # the CPU comparisons need the host platform beside the GPU
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {platform!r}",
              file=sys.stderr)
        return 1

    from chan_vese.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.environ["RUN_GPU_TESTS"] = "1"  # read by tests/conftest.py
    gpu, cpu = devs[0], jax.devices("cpu")[0]
    print(f"card: {card_info()}", flush=True)
    print(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}",
          flush=True)
    t0 = time.perf_counter()
    try:
        if args.four:
            phase_four(devs)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                phase_cli(Path(tmp))
            phase_parity(gpu, cpu)
            phase_families(gpu, cpu)
            phase_gpu_tests()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    stats = gpu.memory_stats() or {}
    print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}; total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"card: {card_info()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
