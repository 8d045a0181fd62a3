"""Multiphase on vector-valued (RGB) images: the general capability
(phase means per channel, channel-averaged squared distances)."""

import jax.numpy as jnp
import numpy as np

from chan_vese.models import multiphase as mp
from chan_vese.params import CVParams


def _rgb_four_regions(h=64, w=64, noise=3.0, seed=0):
    rng = np.random.default_rng(seed)
    colors = np.array([[220.0, 40.0, 40.0],
                       [40.0, 220.0, 40.0],
                       [40.0, 40.0, 220.0],
                       [200.0, 200.0, 200.0]])
    labels = np.zeros((h, w), np.int32)
    labels[: h // 2, w // 2:] = 1
    labels[h // 2:, : w // 2] = 2
    labels[h // 2:, w // 2:] = 3
    img = colors[labels] + noise * rng.standard_normal((h, w, 3))
    return img.astype(np.float64), labels


def test_multiphase_rgb_four_colors():
    import itertools

    img, gt = _rgb_four_regions()
    res = mp.segment_multiphase(jnp.asarray(img),
                                CVParams(mu=0.003 * 255 ** 2, max_iter=200),
                                m_sets=2)
    pred = np.asarray(res.labels)
    best = 0.0
    for perm in itertools.permutations(range(4)):
        best = max(best, float((np.asarray(perm)[pred] == gt).mean()))
    assert best >= 0.99, best
    # per-channel phase means: (2^M, C)
    assert res.cs.shape == (4, 3)


def test_multiphase_rgb_energy_decreases():
    img, _ = _rgb_four_regions()
    tr = mp.segment_multiphase_fixed(jnp.asarray(img),
                                     CVParams(mu=0.003 * 255 ** 2),
                                     iters=40, m_sets=2)
    e = np.asarray(tr.energy)
    assert float((np.diff(e) / np.abs(e[:-1])).max()) < 1e-4


def test_m3_eight_phases_runs():
    """M=3 (8 phases) exercises the general-M machinery."""
    img, _ = _rgb_four_regions()
    res = mp.segment_multiphase(jnp.asarray(img[..., 0]),
                                CVParams(mu=0.003 * 255 ** 2, max_iter=30),
                                m_sets=3)
    assert res.phis.shape == (3, 64, 64)
    assert res.cs.shape == (8,)
    assert int(res.labels.max()) <= 7
