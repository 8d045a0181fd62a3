"""The vectorised NumPy references (ops/sweep_np.py, ops/morph_np.py)
against the straight-line loops and against the jnp operators they check
the drivers with. Shapes cover the awkward cases: single rows/columns,
odd and non-power-of-two widths, tiny heights."""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.ops import morph as morph_ops
from chan_vese.ops import morph_np, sweep_np
from chan_vese.ops.reductions import energy, region_means
from chan_vese.ops.sweep import _update_all, redblack_step
from chan_vese.params import CVParams

SHAPES = [(1, 1), (1, 7), (7, 1), (2, 3), (3, 2), (5, 5), (8, 13),
          (17, 4), (3, 30), (24, 33)]
ARGS = (650.25, 0.5, 1.0, 1e-8)  # mu, dt, eps, eta2


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal(shape) * rng.uniform(0.5, 50)
    f = rng.standard_normal(shape) * rng.uniform(1, 1e4)
    return phi, f


@pytest.mark.parametrize("shape", SHAPES)
def test_vectorised_redblack_equals_loop(shape):
    phi, f = _fields(shape, sum(shape))
    want = sweep_np.redblack_sweep(phi.copy(), f, *ARGS)
    got = sweep_np.redblack_sweep_vec(phi, f, *ARGS)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("shape", SHAPES[3:])
def test_update_all_matches_jnp(shape):
    phi, f = _fields(shape, 7 * sum(shape))
    got = _update_all(jnp.asarray(phi), jnp.asarray(f), *ARGS)
    want = sweep_np.update_all_vec(phi, f, *ARGS)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES[3:])
def test_redblack_step_matches_vectorised_numpy(shape):
    phi, f = _fields(shape, 11 * sum(shape))
    p = CVParams()
    got = redblack_step(jnp.asarray(phi), jnp.asarray(f), p)
    want = sweep_np.redblack_sweep_vec(phi, f, p.mu, p.dt, p.eps, p.eta2)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_region_means_match(channels):
    rng = np.random.default_rng(channels)
    shape = (19, 23) + ((channels,) if channels else ())
    u0 = rng.uniform(0, 255, shape)
    phi = rng.standard_normal((19, 23)) * 4.0
    c1, c2 = region_means(jnp.asarray(u0), jnp.asarray(phi), 1.0)
    n1, n2 = sweep_np.region_means(u0, phi, 1.0)
    np.testing.assert_allclose(np.asarray(c1), n1, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(c2), n2, rtol=1e-12)


@pytest.mark.parametrize("lambdas", [None, ((1.0, 1.5, 0.5),
                                            (0.8, 1.0, 1.2))])
def test_data_term_and_energy_match_rgb(lambdas):
    from chan_vese.ops.reductions import data_term

    rng = np.random.default_rng(5)
    u0 = rng.uniform(0, 255, (13, 17, 3))
    phi = rng.standard_normal((13, 17)) * 3.0
    p = CVParams(nu=3.0)
    l1, l2 = lambdas or p.channel_lambdas(3)
    c1, c2 = sweep_np.region_means(u0, phi, p.eps)
    f = data_term(jnp.asarray(u0), c1, c2, p.nu, jnp.asarray(l1),
                  jnp.asarray(l2))
    fn = sweep_np.data_term(u0, c1, c2, p.nu, np.asarray(l1),
                            np.asarray(l2))
    np.testing.assert_allclose(np.asarray(f), fn, rtol=1e-12)
    e = energy(jnp.asarray(u0), jnp.asarray(phi), c1, c2, p, l1, l2)
    en = sweep_np.energy(u0, phi, c1, c2, p, np.asarray(l1),
                         np.asarray(l2))
    np.testing.assert_allclose(float(e), en, rtol=1e-12)


@pytest.mark.parametrize("shape", [(1, 9), (9, 1), (16, 16), (31, 47)])
def test_energy_matches_gray(shape):
    rng = np.random.default_rng(shape[0] * shape[1])
    u0 = rng.uniform(0, 255, shape)
    phi = rng.standard_normal(shape) * 5.0
    p = CVParams(nu=2.0, lambda1=1.5, lambda2=0.7)
    c1, c2 = sweep_np.region_means(u0, phi, p.eps)
    e = energy(jnp.asarray(u0), jnp.asarray(phi), c1, c2, p)
    en = sweep_np.energy(u0, phi, c1, c2, p, p.lambda1, p.lambda2)
    np.testing.assert_allclose(float(e), en, rtol=1e-12)


def test_chunked_k1_is_segment_fixed():
    rng = np.random.default_rng(9)
    u0 = rng.uniform(0, 255, (20, 30))
    phi0 = rng.standard_normal((20, 30)) * 3.0
    p = CVParams()
    want, _, _, _ = sweep_np.segment_fixed(u0, p, 5, phi0)
    np.testing.assert_array_equal(
        sweep_np.segment_chunked(u0, p, 5, phi0, 1), want)


@pytest.mark.parametrize("m_sets", [1, 2, 3])
def test_multiphase_means_match_jnp(m_sets):
    from chan_vese.models.multiphase import phase_means

    rng = np.random.default_rng(m_sets)
    u0 = rng.uniform(0, 255, (14, 21))
    phis = rng.standard_normal((m_sets, 14, 21)) * 3.0
    got = phase_means(jnp.asarray(u0), jnp.asarray(phis), 1.0)
    want = sweep_np.phase_means(u0, phis, 1.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12)


# --------------------------------------------------------------------------
# morphological operators
# --------------------------------------------------------------------------

MORPH_SHAPES = [(1, 1), (1, 6), (6, 1), (5, 7), (16, 33)]
MORPH_OPS = ["sup_inf", "inf_sup", "dilate8", "erode8"]


@pytest.mark.parametrize("op", MORPH_OPS)
@pytest.mark.parametrize("shape", MORPH_SHAPES)
def test_morph_operator_matches(op, shape):
    rng = np.random.default_rng(len(op) * shape[0] + shape[1])
    u = (rng.uniform(size=shape) > 0.5).astype(np.float64)
    got = getattr(morph_ops, op)(jnp.asarray(u))
    want = getattr(morph_np, op)(u)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("k,smoothing", [(0, 1), (1, 1), (0, 2), (3, 3)])
def test_morph_smooth_alternation_matches(k, smoothing):
    rng = np.random.default_rng(10 * k + smoothing)
    u = (rng.uniform(size=(12, 15)) > 0.5).astype(np.float64)
    got = morph_ops.smooth(jnp.asarray(u), k, smoothing)
    np.testing.assert_array_equal(np.asarray(got),
                                  morph_np.smooth(u, k, smoothing))


def test_morph_chunked_k1_is_per_iteration():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (20, 24))
    ls = (rng.uniform(size=(20, 24)) > 0.5).astype(np.float64)
    np.testing.assert_array_equal(morph_np.morph_acwe(img, ls, 6, 1, k=1),
                                  morph_np.morph_acwe(img, ls, 6, 1))
