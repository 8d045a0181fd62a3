"""Every single-device driver against the f64 NumPy references
(ops/sweep_np.py, ops/morph_np.py), over the case lists the removed
accelerator kernels were tested on: odd and non-aligned widths, tiny
heights, every init, every convergence norm, per-channel lambdas, stacks
and multiphase level-set counts."""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese import (CVParams, segment, segment_batch, segment_fixed,
                       segment_multiphase, segment_multiphase_fixed,
                       segment_stack_fixed, segment_vector,
                       segment_vector_fixed)
from chan_vese.ops import morph_np, sweep_np
from chan_vese.utils.init_phi import init_phi
from fixtures import colored_squares, four_regions, two_disks


def _phi0(shape, p):
    return np.asarray(init_phi(shape, p.init, jnp.float64))


def _check(got, want, tol=1e-9):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) + 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("shape", [(24, 128), (64, 128), (104, 256),
                                   (40, 384), (8, 128), (33, 47),
                                   (5, 300), (3, 3), (130, 17)])
def test_segment_fixed_matches_numpy(shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    u0 = rng.uniform(0, 255, shape)
    p = CVParams()
    tr = segment_fixed(jnp.asarray(u0), p, iters=6)
    phi, es, c1s, c2s = sweep_np.segment_fixed(u0, p, 6, _phi0(shape, p))
    _check(tr.phi, phi)
    np.testing.assert_allclose(np.asarray(tr.energy), es, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(tr.c1), c1s, rtol=1e-10)


@pytest.mark.parametrize("init", ["checkerboard", "circle", "rect",
                                  "small disk"])
@pytest.mark.parametrize("norm", ["flips", "rms", "mean_abs"])
def test_tolerance_driver_trajectory_matches_numpy(init, norm):
    """The tolerance driver stops on its own metric; its state at the
    stopping iteration is the numpy trajectory of that length. (Both are
    f64, but the scheme amplifies last-bit differences roughly tenfold
    every three iterations on the ridges of the circle and rect inits,
    so the cap stays at 10 and phi is compared at 1e-6 of its scale.)"""
    img, _ = two_disks(48, 64, noise=6.0)
    p = CVParams(init=init, conv_norm=norm, max_iter=10, min_iter=2,
                 patience=1, tol=0.05 if norm == "flips" else 20.0)
    res = segment(jnp.asarray(img), p)
    n = int(res.iters)
    assert 2 <= n <= 10
    want, _, _, _ = sweep_np.segment_fixed(img, p, n, _phi0(img.shape, p))
    _check(res.phi, want, 1e-6)
    np.testing.assert_array_equal(np.asarray(res.mask), want >= 0)
    c1, c2 = sweep_np.region_means(img, want, p.eps)
    np.testing.assert_allclose([float(res.c1), float(res.c2)], [c1, c2],
                               rtol=1e-9)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("per_channel", [False, True])
def test_vector_fixed_matches_numpy(channels, per_channel):
    rng = np.random.default_rng(channels)
    u0 = rng.uniform(0, 255, (40, 56, channels))
    if per_channel:
        l1 = tuple(float(x) for x in rng.uniform(0.5, 2.0, channels))
        l2 = tuple(float(x) for x in rng.uniform(0.5, 2.0, channels))
    else:
        l1 = l2 = None
    p = CVParams(init="circle")
    tr = segment_vector_fixed(jnp.asarray(u0), p, iters=5, lambda1=l1,
                              lambda2=l2)
    want, es, _, _ = sweep_np.segment_fixed(u0, p, 5, _phi0((40, 56), p),
                                            l1, l2)
    _check(tr.phi, want)
    np.testing.assert_allclose(np.asarray(tr.energy), es, rtol=1e-9)


def test_vector_tolerance_matches_numpy():
    img, gt = colored_squares(64, 64, noise=5.0)
    p = CVParams(init="circle", max_iter=80)
    res = segment_vector(jnp.asarray(img), p, lambda1=(1.0, 1.2, 0.8),
                         lambda2=(1.0, 0.9, 1.1))
    n = int(res.iters)
    want, _, _, _ = sweep_np.segment_fixed(img, p, n, _phi0((64, 64), p),
                                           (1.0, 1.2, 0.8),
                                           (1.0, 0.9, 1.1))
    _check(res.phi, want)


@pytest.mark.parametrize("frames,shape", [(1, (32, 48)), (3, (32, 48)),
                                          (2, (17, 129))])
def test_stack_fixed_matches_numpy(frames, shape):
    rng = np.random.default_rng(frames)
    stack = rng.uniform(0, 255, (frames,) + shape)
    p = CVParams()
    phis, masks = segment_stack_fixed(jnp.asarray(stack), p, iters=4)
    phi0 = _phi0(shape, p)
    for k in range(frames):
        want, _, _, _ = sweep_np.segment_fixed(stack[k], p, 4, phi0)
        _check(phis[k], want)
        np.testing.assert_array_equal(np.asarray(masks[k]), want >= 0)


def test_batch_tolerance_per_frame_iterations():
    """segment_batch reports each frame's own stopping iteration, and
    each frame equals the single-image driver."""
    frames = [two_disks(48, 48, noise=6.0, seed=s)[0] for s in range(3)]
    frames[2] = frames[2][::-1] * 0.5 + 40.0
    stack = jnp.asarray(np.stack(frames))
    p = CVParams(init="circle", max_iter=120)
    res = segment_batch(stack, p)
    for k in range(3):
        one = segment(stack[k], p)
        assert int(res.iters[k]) == int(one.iters)
        _check(res.phi[k], np.asarray(one.phi))


@pytest.mark.parametrize("m_sets", [1, 2, 3])
@pytest.mark.parametrize("shape", [(32, 32), (24, 40)])
def test_multiphase_fixed_matches_numpy(m_sets, shape):
    from chan_vese.models.multiphase import init_multiphase

    img, _ = four_regions(*shape, noise=4.0)
    p = CVParams(mu=0.003 * 255 ** 2)
    tr = segment_multiphase_fixed(jnp.asarray(img), p, iters=4,
                                  m_sets=m_sets)
    phis0 = np.asarray(init_multiphase(shape, m_sets, dtype=jnp.float64))
    want = sweep_np.segment_multiphase(img, p, 4, phis0)
    _check(tr.phis, want, 1e-8)


def test_multiphase_rgb_matches_numpy():
    from chan_vese.models.multiphase import init_multiphase

    rng = np.random.default_rng(0)
    img, _ = four_regions(32, 32, noise=4.0)
    rgb = np.stack([img, 0.5 * img + 60.0, 255.0 - img], axis=-1) \
        + rng.normal(0, 1.0, (32, 32, 3))
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase(jnp.asarray(rgb), p, m_sets=2, fixed=True,
                             max_iter=3)
    phis0 = np.asarray(init_multiphase((32, 32), 2, dtype=jnp.float64))
    _check(res.phis, sweep_np.segment_multiphase(rgb, p, 3, phis0), 1e-8)


# --------------------------------------------------------------------------
# morphological drivers
# --------------------------------------------------------------------------

def _ls0(shape, init="checkerboard"):
    return (np.asarray(init_phi(shape, init, jnp.float64)) >= 0) \
        .astype(np.float64)


@pytest.mark.parametrize("smoothing", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(5, 7), (33, 65), (64, 200)])
def test_morph_acwe_fixed_matches_numpy(smoothing, shape):
    from chan_vese.models.morph import segment_morph_fixed

    rng = np.random.default_rng(smoothing * 100 + shape[1])
    img = rng.uniform(0, 255, shape)
    tr = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=7,
                             smoothing=smoothing)
    want = morph_np.morph_acwe(img, _ls0(shape), 7, smoothing)
    np.testing.assert_array_equal(np.asarray(tr.ls), want)


@pytest.mark.parametrize("balloon", [-1, 0, 1])
@pytest.mark.parametrize("smoothing", [0, 1, 2])
def test_morph_gac_fixed_matches_numpy(balloon, smoothing):
    from chan_vese.models.morph_gac import segment_gac_fixed

    rng = np.random.default_rng(10 * smoothing + balloon + 1)
    g = rng.uniform(0.01, 1.0, (40, 72))
    ls0 = _ls0((40, 72), "circle")
    tr = segment_gac_fixed(jnp.asarray(g), CVParams(), iters=6,
                           ls0=jnp.asarray(ls0), smoothing=smoothing,
                           balloon=balloon, threshold=0.4)
    want = morph_np.morph_gac(g, ls0, 6, smoothing, balloon, 0.4)
    np.testing.assert_array_equal(np.asarray(tr.ls), want)


@pytest.mark.parametrize("start_iter", [0, 1, 5])
def test_morph_lean_drivers_match_numpy(start_iter):
    """The lean fixed-iteration drivers (the morph benchmark path) with
    an alternation offset: a chunk starting at iteration ``start_iter``
    continues the numpy run exactly."""
    from chan_vese.models.morph import segment_morph_iterations
    from chan_vese.models.morph_gac import segment_gac_iterations

    rng = np.random.default_rng(start_iter)
    img = rng.uniform(0, 255, (36, 52))
    ls0 = _ls0((36, 52))
    head = morph_np.morph_acwe(img, ls0, start_iter, 1)
    got = segment_morph_iterations(jnp.asarray(img), CVParams(), iters=5,
                                   ls0=jnp.asarray(head),
                                   start_iter=start_iter)
    want = morph_np.morph_acwe(img, ls0, start_iter + 5, 1)
    np.testing.assert_array_equal(np.asarray(got.ls), want)
    g = rng.uniform(0.01, 1.0, (36, 52))
    headg = morph_np.morph_gac(g, ls0, start_iter, 1, 1, 0.3)
    gotg = segment_gac_iterations(jnp.asarray(g), CVParams(), iters=5,
                                  ls0=jnp.asarray(headg), balloon=1,
                                  threshold=0.3, start_iter=start_iter)
    np.testing.assert_array_equal(
        np.asarray(gotg.ls), morph_np.morph_gac(g, ls0, start_iter + 5, 1,
                                                1, 0.3))


def test_morph_rgb_per_channel_lambdas_match_numpy():
    from chan_vese.models.morph import segment_morph_fixed

    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (30, 40, 3))
    l1, l2 = (1.0, 2.0, 0.5), (1.0, 1.0, 1.5)
    tr = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=6,
                             lambda1=l1, lambda2=l2)
    want = morph_np.morph_acwe(img, _ls0((30, 40)), 6, 1, l1, l2)
    np.testing.assert_array_equal(np.asarray(tr.ls), want)
