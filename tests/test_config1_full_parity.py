"""The full-size BASELINE.json config-1 parity run (256x256, checkerboard
init, 100 fixed iterations, default mu/nu/dt): C raster reference vs the
JAX exact-parity (wavefront) mode, f64.

~70s on this box's single CPU core (the wavefront schedule is O((2H+W)HW)
per sweep), so it is gated behind RUN_SLOW_TESTS=1. Last recorded result
(2026-08-16): energy-trace max rel dev 1.35e-10, masks identical,
first-zero-flip iteration 16 == 16. See docs/PARITY.md.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese import CVParams, segment_fixed
from chan_vese.utils.init_phi import init_phi
from fixtures import two_disks

pytestmark = pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_TESTS"),
    reason="full-size parity run (~70s); set RUN_SLOW_TESTS=1")


def test_config1_full_parity():
    from native import baseline

    img, _ = two_disks(256, 256, noise=8.0)
    p = CVParams(order="wavefront")
    phi0 = np.asarray(init_phi((256, 256), "checkerboard", jnp.float64),
                      np.float64)
    phi_c, e_c, d_c = baseline.segment_fixed(img, p, 100, phi0)
    tr = segment_fixed(jnp.asarray(img, jnp.float64), p, iters=100,
                       phi0=jnp.asarray(phi0))
    rel = np.abs(np.asarray(tr.energy) - e_c) / np.abs(e_c)
    assert float(rel.max()) < 1e-5     # the BASELINE criterion
    assert float(rel.max()) < 1e-8     # what we actually achieve
    np.testing.assert_array_equal(np.asarray(tr.mask), phi_c >= 0)
    d_j = np.asarray(tr.delta)
    conv_c = int(np.argmax(np.asarray(d_c) == 0.0))
    conv_j = int(np.argmax(d_j == 0.0))
    assert conv_c == conv_j  # iterations-to-convergence parity
