"""Multiphase Vese-Chan tests (eval config 3, BASELINE.json:9)."""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.models import multiphase as mp
from chan_vese.params import CVParams
from fixtures import four_regions

F64 = jnp.float64


def label_accuracy(pred, gt):
    """Best accuracy over label permutations (phase labels are arbitrary)."""
    import itertools

    pred = np.asarray(pred)
    gt = np.asarray(gt)
    k = int(max(pred.max(), gt.max())) + 1
    best = 0.0
    for perm in itertools.permutations(range(k)):
        mapped = np.asarray(perm)[pred]
        best = max(best, float((mapped == gt).mean()))
    return best


def test_phase_weights_partition_of_unity():
    rng = np.random.default_rng(0)
    phis = jnp.asarray(rng.standard_normal((2, 8, 9)))
    ws = mp.phase_weights(phis, eps=1.0)
    assert len(ws) == 4
    total = sum(np.asarray(w) for w in ws)
    np.testing.assert_allclose(total, 1.0, rtol=1e-12)


def test_m2_coupling_matches_survey_formula():
    """The generic coupling term must reduce to the explicit M=2 formulas
    of SURVEY.md §3.3 (Vese-Chan 2002 eqns 10-12)."""
    rng = np.random.default_rng(1)
    u0 = jnp.asarray(rng.uniform(0, 255, size=(6, 7)))
    phis = jnp.asarray(rng.standard_normal((2, 6, 7)) * 5)
    p = CVParams()
    cs = mp.phase_means(u0, phis, p.eps)
    # bit order: s = (s1 | s0): c_s with bit0 = phi_0 inside, bit1 = phi_1
    c00, c10, c01, c11 = (np.asarray(c) for c in cs)  # s=0,1,2,3
    h2 = np.asarray(mp.heaviside(phis[1], p.eps))
    u = np.asarray(u0)
    want_f0 = -(((u - c11) ** 2 - (u - c01) ** 2) * h2
                + ((u - c10) ** 2 - (u - c00) ** 2) * (1 - h2))
    got_f0 = np.asarray(mp._coupling_term(u0, phis, cs, 0, p))
    np.testing.assert_allclose(got_f0, want_f0, rtol=1e-12)
    h1 = np.asarray(mp.heaviside(phis[0], p.eps))
    want_f1 = -(((u - c11) ** 2 - (u - c10) ** 2) * h1
                + ((u - c01) ** 2 - (u - c00) ** 2) * (1 - h1))
    got_f1 = np.asarray(mp._coupling_term(u0, phis, cs, 1, p))
    np.testing.assert_allclose(got_f1, want_f1, rtol=1e-12)


def test_four_region_segmentation():
    img, gt = four_regions(64, 64, noise=4.0)
    # smaller mu: the fixture's disk is only ~8 px at this size and the
    # default length penalty is tuned for larger structures
    p = CVParams(mu=0.003 * 255.0 ** 2, max_iter=300)
    res = mp.segment_multiphase(jnp.asarray(img, F64), p, m_sets=2)
    acc = label_accuracy(res.labels, gt)
    assert acc >= 0.97, acc
    assert int(res.iters) < 300


def test_four_region_512_config3():
    """Eval config 3: 512x512 synthetic piecewise-constant image."""
    img, gt = four_regions(512, 512, noise=4.0)
    res = mp.segment_multiphase(jnp.asarray(img, jnp.float32),
                                CVParams(mu=0.003 * 255.0 ** 2,
                                         max_iter=200), m_sets=2)
    acc = label_accuracy(res.labels, gt)
    assert acc >= 0.99, acc
    assert int(res.iters) < 200


def test_multiphase_energy_decreases():
    img, _ = four_regions(48, 48, noise=3.0)
    tr = mp.segment_multiphase_fixed(jnp.asarray(img, F64), CVParams(),
                                     iters=60, m_sets=2)
    e = np.asarray(tr.energy)
    assert float((np.diff(e) / np.abs(e[:-1])).max()) < 1e-4


def test_m1_reduces_to_scalar_masks():
    """M=1 multiphase == two-phase scalar Chan-Vese (same converged mask)."""
    from chan_vese import segment_fixed
    from chan_vese.utils.init_phi import init_phi
    from fixtures import two_disks, iou

    img, gt = two_disks(48, 48, noise=4.0)
    u = jnp.asarray(img, F64)
    p = CVParams()
    phi0 = init_phi((48, 48), "circle", F64)
    tr_mp = mp.segment_multiphase_fixed(u, p, iters=40, m_sets=1,
                                        phis0=phi0[None])
    tr_sc = segment_fixed(u, p, iters=40, phi0=phi0)
    m_mp = np.asarray(tr_mp.labels) == 1
    np.testing.assert_array_equal(m_mp, np.asarray(tr_sc.mask))


def test_multiphase_with_reinit():
    img, gt = four_regions(64, 64, noise=4.0)
    p = CVParams(mu=0.003 * 255.0 ** 2, max_iter=300,
                 reinit_every=10, reinit_steps=20)
    res = mp.segment_multiphase(jnp.asarray(img, F64), p, m_sets=2)
    assert label_accuracy(res.labels, gt) >= 0.97
    assert bool(jnp.isfinite(res.phis).all())
    # fixed-mode (scan-carry) variant exercises the same cadence
    tr = mp.segment_multiphase_fixed(jnp.asarray(img, F64), p, iters=25,
                                     m_sets=2)
    assert label_accuracy(tr.labels, gt) >= 0.97
    assert bool(jnp.isfinite(tr.phis).all())


def test_labels_from_phis():
    phis = jnp.asarray([[[1.0, -1.0], [1.0, -1.0]],
                        [[1.0, 1.0], [-1.0, -1.0]]])
    lab = np.asarray(mp.labels_from_phis(phis))
    np.testing.assert_array_equal(lab, [[3, 2], [1, 0]])
