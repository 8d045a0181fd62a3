"""Unit tests for ops/reductions.py (region means, data term, energy)."""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.ops import reductions as rd
from chan_vese.params import CVParams

F64 = jnp.float64


def test_region_means_two_region_exact():
    # piecewise-constant image, phi = exact sign of the boundary, tiny eps
    # -> H_eps ~ indicator -> c1, c2 equal the region intensities (SURVEY §4.1)
    u0 = jnp.concatenate([jnp.full((8, 16), 0.9, F64),
                          jnp.full((8, 16), 0.1, F64)], axis=0)
    # note H_eps(z) ~ 1 - eps/(pi z): needs |z| >> 1/tol for indicator limit
    phi = jnp.concatenate([jnp.full((8, 16), 1e6, F64),
                           jnp.full((8, 16), -1e6, F64)], axis=0)
    c1, c2 = rd.region_means(u0, phi, eps=1.0)
    assert float(c1) == pytest.approx(0.9, abs=1e-5)
    assert float(c2) == pytest.approx(0.1, abs=1e-5)


def test_region_means_multichannel():
    rng = np.random.default_rng(1)
    u0 = jnp.asarray(rng.uniform(size=(10, 12, 3)))
    phi = jnp.asarray(rng.standard_normal((10, 12)))
    c1, c2 = rd.region_means(u0, phi, eps=1.0)
    assert c1.shape == (3,) and c2.shape == (3,)
    # cross-check channel 1 against the scalar path
    c1s, c2s = rd.region_means(u0[..., 1], phi, eps=1.0)
    assert float(c1[1]) == pytest.approx(float(c1s), rel=1e-12)
    assert float(c2[1]) == pytest.approx(float(c2s), rel=1e-12)


def test_data_term_sign_convention():
    # pixel matching c1 exactly, far from c2 -> positive force (grows phi)
    u0 = jnp.asarray([[0.9]], dtype=F64)
    f = rd.data_term(u0, 0.9, 0.1, nu=0.0, lambda1=1.0, lambda2=1.0)
    assert float(f[0, 0]) == pytest.approx(+0.64, rel=1e-12)
    # pixel matching c2 -> negative force
    u0 = jnp.asarray([[0.1]], dtype=F64)
    f = rd.data_term(u0, 0.9, 0.1, nu=0.0, lambda1=1.0, lambda2=1.0)
    assert float(f[0, 0]) == pytest.approx(-0.64, rel=1e-12)


def test_data_term_vector_matches_manual():
    rng = np.random.default_rng(2)
    u0 = rng.uniform(size=(5, 6, 3))
    c1 = np.array([0.2, 0.5, 0.7])
    c2 = np.array([0.8, 0.1, 0.3])
    l1 = np.array([1.0, 2.0, 0.5])
    l2 = np.array([0.7, 1.3, 1.0])
    nu = 0.05
    got = rd.data_term(jnp.asarray(u0), jnp.asarray(c1), jnp.asarray(c2),
                       nu, l1, l2)
    want = (-nu - np.mean(l1 * (u0 - c1) ** 2, axis=-1)
            + np.mean(l2 * (u0 - c2) ** 2, axis=-1))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_energy_manual_small_grid():
    rng = np.random.default_rng(3)
    u0 = rng.uniform(size=(4, 5))
    phi = rng.standard_normal((4, 5))
    p = CVParams(mu=0.3, nu=0.05, lambda1=1.1, lambda2=0.9, eps=1.2)
    got = float(rd.energy(jnp.asarray(u0), jnp.asarray(phi), 0.6, 0.2, p))

    H = 0.5 * (1 + (2 / np.pi) * np.arctan(phi / p.eps))
    d = (p.eps / np.pi) / (p.eps ** 2 + phi ** 2)
    gx = np.diff(phi, axis=0, append=phi[-1:])      # forward diff, clamped
    gy = np.diff(phi, axis=1, append=phi[:, -1:])
    want = (p.mu * np.sum(d * np.sqrt(gx ** 2 + gy ** 2))
            + p.nu * np.sum(H)
            + p.lambda1 * np.sum((u0 - 0.6) ** 2 * H)
            + p.lambda2 * np.sum((u0 - 0.2) ** 2 * (1 - H)))
    assert got == pytest.approx(want, rel=1e-12)


def test_delta_norm():
    a = jnp.asarray([[0.0, 3.0]], dtype=F64)
    b = jnp.asarray([[4.0, 0.0]], dtype=F64)
    assert float(rd.delta_norm(a, b, "rms")) == pytest.approx(np.sqrt(12.5))
    assert float(rd.delta_norm(a, b, "mean_abs")) == pytest.approx(3.5)


def test_means_from_sums_partials_roundtrip():
    rng = np.random.default_rng(4)
    u0 = jnp.asarray(rng.uniform(size=(7, 9)))
    phi = jnp.asarray(rng.standard_normal((7, 9)))
    c1a, c2a = rd.region_means(u0, phi, 1.0)
    sums = rd.region_sums(u0, phi, 1.0)
    c1b, c2b = rd.means_from_sums(*sums)
    assert float(c1a) == pytest.approx(float(c1b), rel=1e-14)
    assert float(c2a) == pytest.approx(float(c2b), rel=1e-14)
