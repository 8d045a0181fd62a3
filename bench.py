#!/usr/bin/env python
"""Headline benchmark: Mpixel-iterations/s of the scalar solver at 4K
(3840x2160) on one GPU, against the single-core C baseline of the same
scheme (native/cv_baseline.c) on this host's CPU.

The timed program is the production tolerance driver (models/scalar.
segment) with an unreachable tolerance, so it runs exactly ``--iters``
red-black iterations; each timed call ends in block_until_ready, after
a warm-up call that compiles. Fails without a GPU.

    python bench.py [--iters N] [--reps R] [--trace DIR]

``--trace DIR`` also records one short jax.profiler trace of the 4K loop
into DIR and prints the device operations that took the most time, the
bytes one iteration moves by XLA's own cost model, and the rate those
bytes imply against the card's 3.35 TB/s.
"""

import argparse
import json
import subprocess
import sys
import time

H, W = 2160, 3840
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def _image():
    import numpy as np

    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (H, W)).astype(np.float32)


def time_loop(u0, iters, reps):
    """Best wall time of ``reps`` calls of the iters-long loop."""
    import jax

    from chan_vese import CVParams, segment

    p = CVParams(tol=-1.0, max_iter=iters)
    t0 = time.perf_counter()
    res = segment(u0, p)
    jax.block_until_ready(res)
    compile_s = time.perf_counter() - t0
    if int(res.iters) != iters:
        raise RuntimeError(f"ran {int(res.iters)} iterations, not {iters}")
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(segment(u0, p))
        best = min(best, time.perf_counter() - t0)
    return best, compile_s


def step_bytes(u0):
    """Bytes one red-black iteration (models/scalar.step) accesses, by
    XLA's cost model of the compiled step, computed from its shapes."""
    import jax

    from chan_vese import CVParams
    from chan_vese.models.scalar import step
    from chan_vese.utils.init_phi import init_phi

    p = CVParams()
    phi = init_phi(u0.shape, p.init, u0.dtype)
    cost = jax.jit(lambda a, b: step(a, b, p)).lower(phi, u0).compile() \
        .cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost.get("bytes accessed", float("nan")))


def device_op_times(trace_dir):
    """Total device time per operation name over the GPU stream lines of
    the newest trace in ``trace_dir``, plus the window and busy time."""
    import glob
    import os

    from jax.profiler import ProfileData

    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    totals, spans = {}, []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                n, c = totals.get(ev.name, (0.0, 0))
                totals[ev.name] = (n + ev.duration_ns, c + 1)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return totals, busy, window


def trace(u0, trace_dir, iters=20):
    import jax

    from chan_vese import CVParams, segment

    p = CVParams(tol=-1.0, max_iter=iters)
    jax.block_until_ready(segment(u0, p))  # compiled outside the window
    jax.profiler.start_trace(trace_dir)
    try:
        jax.block_until_ready(segment(u0, p))
    finally:
        jax.profiler.stop_trace()
    totals, busy, window = device_op_times(trace_dir)
    print(f"# trace: {iters} iterations, device window {window / 1e6:.3f} "
          f"ms, busy {busy / 1e6:.3f} ms, idle share "
          f"{1 - busy / window if window else float('nan'):.4f}")
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ns, count) in top:
        print(f"# {ns / 1e6:9.3f} ms {count:6d}x  "
              f"{ns / count / 1e3:9.2f} us  {name[:100]}")
    nbytes = step_bytes(u0)
    per_iter_s = busy / 1e9 / iters
    print(f"# step bytes accessed (XLA cost model) {nbytes:.0f} = "
          f"{nbytes / (H * W):.1f} B/pixel-iteration; at the traced "
          f"{per_iter_s * 1e3:.4f} ms/iteration busy that is "
          f"{nbytes / per_iter_s / 1e9:.1f} GB/s = "
          f"{nbytes / per_iter_s / HBM_BYTES_PER_S:.3f} of 3.35 TB/s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    from chan_vese.compile_cache import enable_compile_cache

    enable_compile_cache()
    u0 = jax.device_put(_image(), dev)
    secs, compile_s = time_loop(u0, args.iters, args.reps)
    value = H * W * args.iters / secs / 1e6

    from native import baseline

    c_mpix = baseline.bench_mpixel_iters_per_sec(h=512, w=512, iters=8,
                                                 repeats=2)
    if args.trace:
        trace(u0, args.trace)
    print(json.dumps({
        "metric": "Mpixel-iters/s, 4K scalar Chan-Vese, XLA red-black "
                  "tolerance driver",
        "value": value,
        "unit": "Mpixel-iters/s",
        "vs_baseline": value / c_mpix,
        "baseline_c_mpixel_iters_per_s": c_mpix,
        "iters": args.iters, "seconds": secs, "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_info(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
