#!/usr/bin/env python
"""Regenerate the golden traces from the C baseline (see README.md)."""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from fixtures import two_disks  # noqa: E402
from chan_vese.params import CVParams  # noqa: E402
from chan_vese.utils.init_phi import init_phi  # noqa: E402
from chan_vese.utils.trace import write_energy_csv  # noqa: E402
from native import baseline  # noqa: E402

HERE = Path(__file__).resolve().parent
img, _ = two_disks(64, 64, noise=8.0)
p = CVParams()
for kind in ("checkerboard", "circle"):
    phi0 = np.asarray(init_phi((64, 64), kind, jnp.float64), np.float64)
    phi, e, d = baseline.segment_fixed(img, p, 60, phi0)
    write_energy_csv(HERE / f"config1_64_{kind}_f64.csv", e, d)
    if kind == "checkerboard":
        np.save(HERE / "config1_64_checkerboard_phi.npy", phi)
print("goldens regenerated")
