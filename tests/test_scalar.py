"""Integration tests for the scalar model (SURVEY.md §4.2).

Characterized behavior at the canonical [0,255] operating point (see
CVParams docstring): segmentation of clean fixtures completes within tens
of iterations; phi keeps drifting afterwards (t^(1/3) growth in settled
regions) which is why the default convergence metric is mask-flip fraction.
The polarity of the final mask (which region ends phi >= 0) is not
determined for the symmetric energy (lambda1 == lambda2, nu == 0) under
checkerboard init - tests accept either; circle init pins polarity
(interior starts positive over the object-rich center).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese import CVParams, segment, segment_fixed
from fixtures import iou, two_disks

F64 = jnp.float64


def best_iou(mask, gt):
    return max(iou(mask, gt), iou(~np.asarray(mask), gt))


def test_two_disks_circle_init_converges_fast():
    img, gt = two_disks(64, 64, noise=8.0)
    p = CVParams(init="circle")
    res = segment(jnp.asarray(img, F64), p)
    assert int(res.iters) < 30  # flips converge within a few iterations
    assert iou(np.asarray(res.mask), gt) >= 0.99
    assert float(res.c1) == pytest.approx(217.0, abs=8.0)
    assert float(res.c2) == pytest.approx(38.0, abs=8.0)


def test_config1_checkerboard_256_100iters():
    """Eval config 1 (BASELINE.json:7): 256x256, checkerboard init,
    100 fixed iterations, default mu/nu/dt."""
    img, gt = two_disks(256, 256, noise=8.0)
    tr = segment_fixed(jnp.asarray(img, F64), CVParams(), iters=100)
    assert best_iou(np.asarray(tr.mask), gt) >= 0.99


def test_energy_decreases():
    img, _ = two_disks(64, 64, noise=5.0)
    tr = segment_fixed(jnp.asarray(img, F64), CVParams(init="circle"),
                       iters=80)
    e = np.asarray(tr.energy)
    rises = np.diff(e) / np.abs(e[:-1])
    assert float(rises.max()) < 1e-6


def test_trace_shapes_and_mask_consistency():
    img, _ = two_disks(32, 32)
    tr = segment_fixed(jnp.asarray(img, F64), CVParams(), iters=20)
    assert tr.energy.shape == (20,)
    assert tr.delta.shape == (20,)
    assert tr.c1.shape == (20,)
    np.testing.assert_array_equal(np.asarray(tr.mask),
                                  np.asarray(tr.phi) >= 0)


def test_orderings_agree_on_converged_mask():
    """Red-black / jacobi / raster-GS(wavefront) trajectories differ during
    the violent early transient (documented deviation from SURVEY.md's
    hoped-for 1e-5 trace parity of red-black; the exact-parity mode is the
    wavefront kernel, see test_c_baseline.py) but must agree on the
    converged segmentation and final energy."""
    from chan_vese.ops.reductions import energy, region_means

    img, gt = two_disks(64, 64, noise=5.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    results = {}
    for order in ("redblack", "jacobi", "wavefront"):
        tr = segment_fixed(u, p.replace(order=order), iters=60)
        results[order] = (np.asarray(tr.mask), float(tr.energy[-1]))
    m_wf, e_wf = results["wavefront"]
    for order in ("redblack", "jacobi"):
        m, e = results[order]
        assert iou(m, m_wf) >= 0.995, order
        # energies track the post-convergence phi drift whose *rate* is
        # ordering-dependent (GS ~2x Jacobi per sweep), so same-iteration
        # energies agree only loosely across orderings; exact trace parity
        # is wavefront-vs-raster (test_c_baseline.py).
        assert abs(e - e_wf) / abs(e_wf) < 0.15, order


def test_iterations_to_convergence_parity():
    """Iterations-to-convergence parity across orderings (BASELINE.json:2),
    under the flip-fraction criterion."""
    img, _ = two_disks(64, 64, noise=5.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle", max_iter=200)
    iters = {o: int(segment(u, p.replace(order=o)).iters)
             for o in ("redblack", "wavefront", "jacobi")}
    assert all(v < 200 for v in iters.values()), iters
    assert abs(iters["redblack"] - iters["wavefront"]) <= 3, iters


def test_f32_matches_f64_mask():
    img, gt = two_disks(64, 64, noise=8.0)
    p = CVParams(init="circle")
    m32 = np.asarray(segment_fixed(jnp.asarray(img, jnp.float32), p,
                                   iters=40).mask)
    m64 = np.asarray(segment_fixed(jnp.asarray(img, F64), p,
                                   iters=40).mask)
    assert iou(m32, m64) >= 0.995


def test_normalization_scaling_matters():
    """Regression for the operating-point pitfall (SURVEY.md §7).

    (a) A [0,1] image with unadjusted [0,255]-scaled defaults stalls.
    (b) The scheme's exact scale invariance: u -> u/s with mu -> mu/s^2 AND
        eps -> eps/s evolves phi -> phi/s, so the mask trajectory is
        IDENTICAL (the absolute scale of the scheme is eps).
    """
    img, gt = two_disks(64, 64, noise=8.0)
    img01 = img / 255.0
    p = CVParams(init="circle")
    stalled = segment_fixed(jnp.asarray(img01, F64), p, iters=60)
    assert best_iou(np.asarray(stalled.mask), gt) < 0.9

    s = 255.0
    p_scaled = p.replace(mu=p.mu / s ** 2, eps=p.eps / s, eta2=p.eta2 / s ** 2)
    from chan_vese.utils.init_phi import init_phi
    phi0 = init_phi((64, 64), "circle", F64)
    ref = segment_fixed(jnp.asarray(img, F64), p, iters=60, phi0=phi0)
    scaled = segment_fixed(jnp.asarray(img01, F64), p_scaled, iters=60,
                           phi0=phi0 / s)
    np.testing.assert_array_equal(np.asarray(scaled.mask),
                                  np.asarray(ref.mask))
    # exact in real arithmetic; fp rounding differs between the two scales
    # and gets amplified by 60 iterations of sharp-interface dynamics, so
    # only a loose pointwise check on phi is meaningful (masks are equal).
    np.testing.assert_allclose(np.asarray(scaled.phi) * s,
                               np.asarray(ref.phi), rtol=5e-2, atol=1.0)


def test_reinit_keeps_gradient_bounded():
    from chan_vese.ops.numerics import grad_central

    img, gt = two_disks(64, 64, noise=5.0)
    p = CVParams(init="circle", reinit_every=10, reinit_steps=30)
    tr = segment_fixed(jnp.asarray(img, F64), p, iters=100)
    assert iou(np.asarray(tr.mask), gt) >= 0.99
    gx, gy = grad_central(tr.phi)
    g = np.asarray(jnp.sqrt(gx ** 2 + gy ** 2))
    # near the zero contour the redistanced phi has |grad| ~ 1
    band = np.abs(np.asarray(tr.phi)) < 3.0
    assert 0.5 < np.median(g[band]) < 1.5


def test_checkerboard_init_matches_baseline_formula():
    from chan_vese.utils.init_phi import checkerboard

    phi = np.asarray(checkerboard((16, 16), jnp.float64))
    i, j = np.mgrid[0:16, 0:16]
    want = np.sin(np.pi * i / 5.0) * np.sin(np.pi * j / 5.0)
    np.testing.assert_allclose(phi, want, atol=1e-12)
