"""Parity chain against the native single-core C baseline (SURVEY.md §4.5).

C raster GS (f64)  ==  NumPy raster transcription  ==  JAX wavefront kernel

This realizes the BASELINE.json:5 parity criterion ("energy-trace agreement
<=1e-5 at fixed iteration count") against the reference stand-in: the
reference mount was empty (SURVEY.md §0), so the C baseline - an
independent transcription of the same published scheme - plays the
reference's role, and the JAX parity mode (order='wavefront') must match
its trace far tighter than 1e-5.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fixtures import two_disks
from chan_vese import CVParams, segment_fixed
from chan_vese.ops import sweep_np
from chan_vese.ops.reductions import energy as jenergy
from chan_vese.ops.reductions import region_means as jmeans
from chan_vese.utils.init_phi import init_phi
from native import baseline

F64 = jnp.float64


@pytest.fixture(scope="module")
def lib():
    baseline.build()
    return baseline


def test_c_sweep_matches_numpy(lib):
    rng = np.random.default_rng(0)
    phi = rng.standard_normal((13, 17))
    f = rng.standard_normal((13, 17)) * 100
    args = dict(mu=650.25, dt=0.5, eps=1.0, eta2=1e-8)
    got = lib.sweep(phi, f, **args)
    want = sweep_np.raster_sweep(phi.copy(), f, **args)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_c_region_means_and_energy_match_jax(lib):
    img, _ = two_disks(32, 32, noise=5.0)
    rng = np.random.default_rng(1)
    phi = rng.standard_normal((32, 32)) * 20
    c1c, c2c = lib.region_means(img, phi, 1.0)
    c1j, c2j = jmeans(jnp.asarray(img), jnp.asarray(phi), 1.0)
    assert c1c == pytest.approx(float(c1j), rel=1e-12)
    assert c2c == pytest.approx(float(c2j), rel=1e-12)
    p = CVParams()
    ec = lib.energy(img, phi, p.mu, p.nu, p.lambda1, p.lambda2, p.eps)
    ej = float(jenergy(jnp.asarray(img), jnp.asarray(phi),
                       c1j, c2j, p))
    assert ec == pytest.approx(ej, rel=1e-12)


def test_energy_trace_parity_c_vs_wavefront(lib):
    """THE parity artifact: full fixed-iteration energy traces, C raster
    baseline vs JAX wavefront mode, <=1e-5 relative (achieved: ~1e-12)."""
    img, _ = two_disks(48, 48, noise=5.0)
    iters = 40
    p = CVParams(order="wavefront", init="circle")
    phi0 = np.asarray(init_phi((48, 48), "circle", F64), np.float64)

    phi_c, e_c, d_c = lib.segment_fixed(img, p, iters, phi0)
    tr = segment_fixed(jnp.asarray(img, F64), p, iters=iters,
                       phi0=jnp.asarray(phi0, F64))
    e_j = np.asarray(tr.energy)

    rel = np.abs(e_j - e_c) / np.abs(e_c)
    assert float(rel.max()) < 1e-5   # the BASELINE.json criterion
    assert float(rel.max()) < 1e-8   # what we actually achieve
    # phi pointwise: ~1e-7 relative after 40 iterations (fp op-order
    # differences between the vectorized-masked schedule and the scalar C
    # loop get amplified by the sharp-interface dynamics)
    np.testing.assert_allclose(np.asarray(tr.phi), phi_c,
                               rtol=1e-5, atol=1e-5)
    # iterations-to-convergence parity: first iteration with zero flips
    d_j = np.asarray(tr.delta)
    conv_c = int(np.argmax(d_c == 0.0)) if (d_c == 0).any() else iters
    conv_j = int(np.argmax(d_j == 0.0)) if (d_j == 0).any() else iters
    assert conv_c == conv_j


def test_energy_trace_parity_checkerboard_config1_small(lib):
    """Config-1 style (checkerboard init, default params) on a smaller
    grid to keep the sequential C run fast in CI."""
    img, _ = two_disks(64, 64, noise=8.0)
    iters = 50
    p = CVParams(order="wavefront")
    phi0 = np.asarray(init_phi((64, 64), "checkerboard", F64), np.float64)
    _, e_c, _ = lib.segment_fixed(img, p, iters, phi0)
    tr = segment_fixed(jnp.asarray(img, F64), p, iters=iters,
                       phi0=jnp.asarray(phi0, F64))
    rel = np.abs(np.asarray(tr.energy) - e_c) / np.abs(e_c)
    assert float(rel.max()) < 1e-5
