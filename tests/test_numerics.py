"""Unit tests for ops/numerics.py (SURVEY.md §4.1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.ops import numerics as nm

F64 = jnp.float64


class TestHeavisideDirac:
    def test_limits(self):
        eps = 1.0
        assert float(nm.heaviside(jnp.asarray(0.0, F64), eps)) == pytest.approx(0.5)
        assert float(nm.heaviside(jnp.asarray(1e9, F64), eps)) == pytest.approx(1.0, abs=1e-8)
        assert float(nm.heaviside(jnp.asarray(-1e9, F64), eps)) == pytest.approx(0.0, abs=1e-8)

    def test_dirac_is_grad_of_heaviside(self):
        eps = 0.7
        g = jax.grad(lambda z: nm.heaviside(z, eps))
        for z in [-3.0, -0.5, 0.0, 0.2, 4.0]:
            z = jnp.asarray(z, F64)
            assert float(g(z)) == pytest.approx(float(nm.dirac(z, eps)), rel=1e-12)

    def test_dirac_symmetric_positive(self):
        z = jnp.linspace(-5, 5, 101, dtype=F64)
        d = nm.dirac(z, 1.3)
        assert bool(jnp.all(d > 0))
        np.testing.assert_allclose(np.asarray(d), np.asarray(d[::-1]), rtol=1e-14)


class TestShifts:
    def test_clamped_semantics(self):
        x = jnp.arange(12, dtype=F64).reshape(3, 4)
        np.testing.assert_array_equal(np.asarray(nm.shift_up(x)),
                                      np.asarray(x)[[0, 0, 1], :])
        np.testing.assert_array_equal(np.asarray(nm.shift_down(x)),
                                      np.asarray(x)[[1, 2, 2], :])
        np.testing.assert_array_equal(np.asarray(nm.shift_left(x)),
                                      np.asarray(x)[:, [0, 0, 1, 2]])
        np.testing.assert_array_equal(np.asarray(nm.shift_right(x)),
                                      np.asarray(x)[:, [1, 2, 3, 3]])


class TestCurvature:
    def test_flat_plane_zero(self):
        # linear phi -> |grad| const -> div(grad/|grad|) = 0 (interior)
        i = jnp.arange(32, dtype=F64)[:, None] * jnp.ones((1, 32), F64)
        j = jnp.ones((32, 1), F64) * jnp.arange(32, dtype=F64)[None, :]
        phi = 0.3 * i + 0.7 * j + 1.0
        k = nm.curvature(phi, 1e-16)
        assert float(jnp.max(jnp.abs(k[2:-2, 2:-2]))) < 1e-10

    def test_circle_sdf_curvature(self):
        # signed distance to circle of radius r: kappa = -1/r at distance 0
        # (our sign convention: phi positive inside, kappa = div(grad phi/|grad phi|),
        # grad points inward-to-outward... check magnitude on the circle band)
        n, r = 128, 30.0
        c = (n - 1) / 2.0
        i = jnp.arange(n, dtype=F64)[:, None] * jnp.ones((1, n), F64)
        j = jnp.ones((n, 1), F64) * jnp.arange(n, dtype=F64)[None, :]
        dist = jnp.sqrt((i - c) ** 2 + (j - c) ** 2)
        phi = r - dist  # positive inside
        k = nm.curvature(phi, 1e-16)
        band = jnp.abs(dist - r) < 1.0
        expect = -1.0 / r  # curvature of level sets of (r - dist) is -1/dist
        vals = np.asarray(k)[np.asarray(band)]
        np.testing.assert_allclose(vals, expect, rtol=0.15)

    def test_face_coeffs_match_definition(self):
        rng = np.random.default_rng(0)
        phi = jnp.asarray(rng.standard_normal((6, 7)))
        mu, eta2 = 0.4, 1e-8
        A, B = nm.face_coeffs(phi, mu, eta2)
        p = np.asarray(phi)
        H, W = p.shape

        def at(i, jj):
            return p[min(max(i, 0), H - 1), min(max(jj, 0), W - 1)]

        for i in range(H):
            for j in range(W):
                dxp = at(i + 1, j) - at(i, j)
                dy0 = 0.5 * (at(i, j + 1) - at(i, j - 1))
                a = mu / np.sqrt(eta2 + dxp ** 2 + dy0 ** 2)
                dx0 = 0.5 * (at(i + 1, j) - at(i - 1, j))
                dyp = at(i, j + 1) - at(i, j)
                b = mu / np.sqrt(eta2 + dx0 ** 2 + dyp ** 2)
                assert float(A[i, j]) == pytest.approx(a, rel=1e-12)
                assert float(B[i, j]) == pytest.approx(b, rel=1e-12)
