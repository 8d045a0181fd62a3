#!/usr/bin/env python
"""End-to-end demo: synthesize images, run every model family, write
artifacts into ./demo_out (masks, overlays, label maps, energy trace,
evolution GIF). Runs on CPU or GPU.

    python examples/demo.py [outdir]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(outdir="demo_out"):
    import jax.numpy as jnp

    from chan_vese import (CVParams, segment, segment_fixed,
                           segment_multiphase, segment_vector)
    from chan_vese.utils import image_io, trace

    out = Path(outdir)
    out.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    p = CVParams(init="circle")

    # --- scalar grayscale ------------------------------------------------
    i, j = np.mgrid[0:256, 0:256].astype(float)
    gray = np.where((np.hypot(i - 80, j - 90) < 40)
                    | (np.hypot(i - 170, j - 170) < 50), 217.0, 38.0)
    gray += 8 * rng.standard_normal(gray.shape)
    u = jnp.asarray(gray, jnp.float32)
    res = segment(u, p)
    print(f"scalar: {int(res.iters)} iters, c1={float(res.c1):.1f}, "
          f"c2={float(res.c2):.1f}")
    image_io.save_mask(out / "scalar_mask.png", res.mask)
    image_io.save_overlay(out / "scalar_overlay.png", gray, res.mask)

    # energy trace + evolution
    tr = segment_fixed(u, p, iters=60)
    trace.write_energy_csv(out / "scalar_trace.csv", tr.energy, tr.delta,
                           tr.c1, tr.c2)

    # --- vector-valued RGB ----------------------------------------------
    rgb = np.full((256, 256, 3), (30.0, 40.0, 50.0))
    rgb[40:120, 40:150] = (230.0, 200.0, 60.0)
    rgb[150:220, 120:230] = (210.0, 60.0, 230.0)
    rgb += 5 * rng.standard_normal(rgb.shape)
    res = segment_vector(jnp.asarray(rgb, jnp.float32), p,
                         lambda1=(1.0, 1.2, 0.8))
    print(f"rgb: {int(res.iters)} iters, c1={np.asarray(res.c1).round(0)}")
    image_io.save_overlay(out / "rgb_overlay.png", rgb, res.mask)

    # --- multiphase (4 phases) -------------------------------------------
    vals = np.array([13.0, 89.0, 166.0, 242.0])
    lab = (i > 128).astype(int) * 2 + (j > 128).astype(int)
    mp_img = vals[lab] + 4 * rng.standard_normal(lab.shape)
    res = segment_multiphase(jnp.asarray(mp_img, jnp.float32),
                             CVParams(mu=0.003 * 255 ** 2), m_sets=2)
    print(f"multiphase: {int(res.iters)} iters, "
          f"{len(np.unique(np.asarray(res.labels)))} phases used")
    image_io.save_labels(out / "multiphase_labels.png", res.labels)

    print(f"artifacts in {out}/")


if __name__ == "__main__":
    main(*sys.argv[1:])
