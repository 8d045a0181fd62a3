"""Randomized cross-implementation equivalence (fuzzing the jnp drivers
and sweeps against the independent NumPy references of ops/sweep_np.py
and ops/morph_np.py, and the C baseline, over shapes/params/dtypes that
the fixed tests don't pin)."""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.ops import morph_np, sweep, sweep_np
from chan_vese.ops.reductions import data_term, region_means
from chan_vese.params import CVParams

RNG = np.random.default_rng(2026)


def _rand_params(rng):
    return CVParams(
        mu=float(rng.uniform(10, 2000)),
        nu=float(rng.uniform(-50, 50)),
        lambda1=float(rng.uniform(0.3, 3.0)),
        lambda2=float(rng.uniform(0.3, 3.0)),
        dt=float(rng.uniform(0.1, 2.0)),
        eps=float(rng.uniform(0.3, 3.0)),
        eta2=float(10.0 ** rng.uniform(-12, -4)),
    )


def _close(got, want, rtol, atol_rel, msg=""):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) + 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * scale, err_msg=msg)


@pytest.mark.parametrize("trial", range(6))
def test_redblack_step_f32_matches_numpy_random(trial):
    """Random shapes (odd and non-aligned widths, tiny H) x random
    params: the f32 jnp red-black iteration (means, data term, sweep)
    == the vectorised f64 numpy reference within f32 rounding."""
    rng = np.random.default_rng(100 + trial)
    h = int(rng.integers(2, 130))
    w = int(rng.integers(2, 400))
    p = _rand_params(rng)
    u0 = rng.uniform(0, 255, (h, w)).astype(np.float32)
    phi = (rng.standard_normal((h, w)) * rng.uniform(0.5, 50)
           ).astype(np.float32)
    c1, c2 = region_means(jnp.asarray(u0), jnp.asarray(phi), p.eps)
    f = data_term(jnp.asarray(u0), c1, c2, p.nu, p.lambda1, p.lambda2)
    got = sweep.redblack_step(jnp.asarray(phi), f, p)
    n1, n2 = sweep_np.region_means(u0, phi, p.eps)
    np.testing.assert_allclose([float(c1), float(c2)], [n1, n2],
                               rtol=1e-5)
    fn = sweep_np.data_term(u0, n1, n2, p.nu, p.lambda1, p.lambda2)
    want = sweep_np.redblack_sweep_vec(phi, fn, p.mu, p.dt, p.eps, p.eta2)
    _close(got, want, 1e-4, 1e-4, f"shape=({h},{w}) p={p}")


@pytest.mark.parametrize("trial", range(4))
def test_wavefront_equals_raster_random(trial):
    """Random small grids x random params: wavefront == raster GS (f64)."""
    rng = np.random.default_rng(200 + trial)
    h, w = int(rng.integers(3, 20)), int(rng.integers(3, 20))
    p = _rand_params(rng)
    phi = rng.standard_normal((h, w)) * rng.uniform(0.5, 100)
    f = rng.standard_normal((h, w)) * rng.uniform(1, 1e4)
    got = np.asarray(sweep.wavefront_step(
        jnp.asarray(phi, jnp.float64), jnp.asarray(f, jnp.float64), p))
    want = sweep_np.raster_sweep(phi.astype(np.float64).copy(),
                                 f.astype(np.float64), p.mu, p.dt, p.eps,
                                 p.eta2)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("trial", range(4))
def test_redblack_jnp_equals_numpy_random(trial):
    rng = np.random.default_rng(300 + trial)
    h, w = int(rng.integers(3, 18)), int(rng.integers(3, 18))
    p = _rand_params(rng)
    phi = rng.standard_normal((h, w)) * rng.uniform(0.5, 100)
    f = rng.standard_normal((h, w)) * rng.uniform(1, 1e4)
    got = np.asarray(sweep.redblack_step(
        jnp.asarray(phi, jnp.float64), jnp.asarray(f, jnp.float64), p))
    want = sweep_np.redblack_sweep(phi.astype(np.float64),
                                   f.astype(np.float64), p.mu, p.dt,
                                   p.eps, p.eta2)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("trial", range(3))
def test_c_baseline_matches_numpy_random(trial):
    from native import baseline

    rng = np.random.default_rng(400 + trial)
    h, w = int(rng.integers(4, 24)), int(rng.integers(4, 24))
    p = _rand_params(rng)
    phi = rng.standard_normal((h, w)) * rng.uniform(0.5, 100)
    f = rng.standard_normal((h, w)) * rng.uniform(1, 1e4)
    got = baseline.sweep(phi, f, p.mu, p.dt, p.eps, p.eta2)
    want = sweep_np.raster_sweep(phi.copy(), f, p.mu, p.dt, p.eps, p.eta2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("trial", range(5))
def test_commk_chunk_matches_frozen_means_numpy_random(trial):
    """Random shapes x params x k: the communication-avoiding sharded
    chunks (1x1 mesh, f64) == the frozen-means numpy chunk reference."""
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    rng = np.random.default_rng(300 + trial)
    k = int(rng.integers(1, 6))
    h = int(rng.integers(4 * k, 70))
    w = int(rng.integers(4 * k, 140))
    iters = int(rng.integers(k, 3 * k + 2))
    p = _rand_params(rng)
    u0 = rng.uniform(0, 255, (h, w))
    phi0 = rng.standard_normal((h, w)) * rng.uniform(0.5, 20)
    res = segment_sharded(jnp.asarray(u0), p, make_grid_mesh(1, 1),
                          phi0=jnp.asarray(phi0), max_iter=iters,
                          fixed=True, comm_k=k)
    want = sweep_np.segment_chunked(u0, p, iters, phi0, k)
    _close(res.phi, want, 1e-9, 1e-9, f"({h},{w}) k={k} iters={iters}")


@pytest.mark.parametrize("trial", range(4))
def test_multiphase_step_matches_numpy_random(trial):
    """Random shapes x params: one coupled 4-phase iteration
    (models/multiphase.multiphase_step, f64) == the numpy reference."""
    from chan_vese.models import multiphase as mp

    rng = np.random.default_rng(400 + trial)
    h = int(rng.integers(3, 60))
    w = int(rng.integers(3, 140))
    p = _rand_params(rng)
    u0 = rng.uniform(0, 255, (h, w))
    phis = rng.standard_normal((2, h, w)) * rng.uniform(0.5, 10)
    got, cs = mp.multiphase_step(jnp.asarray(phis), jnp.asarray(u0), p)
    want, cs_np = sweep_np.multiphase_step(phis, u0, p)
    np.testing.assert_allclose(np.asarray(cs), np.asarray(cs_np),
                               rtol=1e-10)
    _close(got, want, 1e-9, 1e-9, f"shape=({h},{w}) p={p}")


@pytest.mark.parametrize("trial", range(3))
def test_vector_step_matches_numpy_random(trial):
    """Random (H, W, C) shapes/params/per-channel lambdas: one vector-
    valued iteration (models/scalar.step, f64) == the numpy reference."""
    from chan_vese.models.scalar import step

    rng = np.random.default_rng(500 + trial)
    h = int(rng.integers(3, 50))
    w = int(rng.integers(3, 150))
    c = int(rng.integers(1, 5))
    p = _rand_params(rng)
    l1 = tuple(float(x) for x in rng.uniform(0.3, 3.0, c))
    l2 = tuple(float(x) for x in rng.uniform(0.3, 3.0, c))
    u0 = rng.uniform(0, 255, (h, w, c))
    phi = rng.standard_normal((h, w)) * rng.uniform(0.5, 10)
    got, c1, c2, _ = step(jnp.asarray(phi), jnp.asarray(u0), p, l1, l2)
    n1, n2 = sweep_np.region_means(u0, phi, p.eps)
    np.testing.assert_allclose(np.asarray(c1), n1, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(c2), n2, rtol=1e-10)
    f = sweep_np.data_term(u0, n1, n2, p.nu, np.asarray(l1), np.asarray(l2))
    want = sweep_np.redblack_sweep_vec(phi, f, p.mu, p.dt, p.eps, p.eta2)
    _close(got, want, 1e-9, 1e-9, f"shape=({h},{w},{c}) p={p}")


@pytest.mark.parametrize("trial", range(4))
def test_sharded_commk_grid_matches_frozen_means_numpy_random(trial):
    """Random shard geometries on a 2x2 mesh x params x k: the sharded
    chunk loop (deep halos, global-edge replica resync) == the
    unsharded frozen-means numpy reference."""
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    rng = np.random.default_rng(600 + trial)
    k = int(rng.integers(1, 5))
    h = 2 * int(rng.integers(2 * k, 24))
    w = 2 * int(rng.integers(2 * k, 40))
    iters = int(rng.integers(k, 3 * k + 2))
    p = _rand_params(rng)
    u0 = rng.uniform(0, 255, (h, w))
    phi0 = rng.standard_normal((h, w)) * rng.uniform(0.5, 20)
    res = segment_sharded(jnp.asarray(u0), p, make_grid_mesh(2, 2),
                          phi0=jnp.asarray(phi0), max_iter=iters,
                          fixed=True, comm_k=k)
    want = sweep_np.segment_chunked(u0, p, iters, phi0, k)
    _close(res.phi, want, 1e-9, 1e-9, f"({h},{w}) k={k} iters={iters}")


@pytest.mark.parametrize("trial", range(4))
def test_segment_fixed_trace_matches_numpy_random(trial):
    """Random shapes x params x inits: the multi-iteration trace driver
    (models/scalar.segment_fixed, f64) == the numpy trajectory: phi,
    the means each sweep used and the post-sweep energy."""
    from chan_vese.models.scalar import segment_fixed
    from chan_vese.utils.init_phi import init_phi

    rng = np.random.default_rng(700 + trial)
    h = int(rng.integers(8, 64))
    w = int(rng.integers(8, 130))
    iters = int(rng.integers(2, 8))
    p = _rand_params(rng).replace(
        init=["checkerboard", "circle", "rect", "small disk"][trial])
    u0 = rng.uniform(0, 255, (h, w))
    tr = segment_fixed(jnp.asarray(u0), p, iters=iters)
    phi0 = np.asarray(init_phi((h, w), p.init, jnp.float64))
    phi, es, c1s, c2s = sweep_np.segment_fixed(u0, p, iters, phi0)
    _close(tr.phi, phi, 1e-9, 1e-9, f"({h},{w}) init={p.init}")
    np.testing.assert_allclose(np.asarray(tr.energy), es, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(tr.c1), c1s, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(tr.c2), c2s, rtol=1e-9)


@pytest.mark.parametrize("trial", range(6))
def test_morph_drivers_match_numpy_random(trial):
    """Random geometries x smoothing x balloon x iterations: MorphGAC and
    MorphACWE (f64) are BITWISE the numpy transcription (binary state)."""
    from chan_vese.models.morph import segment_morph_fixed
    from chan_vese.models.morph_gac import segment_gac_fixed

    rng = np.random.default_rng(300 + trial)
    h = int(rng.integers(5, 90))
    w = int(rng.integers(5, 200))
    smoothing = int(rng.integers(0, 3))
    iters = int(rng.integers(1, 9))
    balloon = int(rng.integers(-1, 2))
    thr = float(rng.uniform(0.1, 0.7))
    g = rng.uniform(0.01, 1.0, (h, w))
    ls0 = (rng.uniform(size=(h, w)) > 0.5).astype(np.float64)
    p = CVParams()
    got = segment_gac_fixed(jnp.asarray(g), p, iters=iters,
                            ls0=jnp.asarray(ls0), smoothing=smoothing,
                            balloon=balloon, threshold=thr)
    want = morph_np.morph_gac(g, ls0, iters, smoothing, balloon, thr)
    np.testing.assert_array_equal(
        np.asarray(got.ls), want,
        err_msg=f"gac {h}x{w} it={iters} s={smoothing} b={balloon}")
    u0 = rng.uniform(0, 255, (h, w))
    got_a = segment_morph_fixed(jnp.asarray(u0), p, iters=iters,
                                ls0=jnp.asarray(ls0), smoothing=smoothing)
    want_a = morph_np.morph_acwe(u0, ls0, iters, smoothing)
    np.testing.assert_array_equal(
        np.asarray(got_a.ls), want_a,
        err_msg=f"acwe {h}x{w} it={iters} s={smoothing}")


@pytest.mark.parametrize("trial", range(3))
def test_gac_lean_driver_matches_numpy_large(trial):
    """The lean GAC driver at a larger, non-square geometry (the size
    class the morph benchmarks run) stays bitwise the numpy reference."""
    from chan_vese.models.morph_gac import segment_gac_iterations

    rng = np.random.default_rng(400 + trial)
    h, w = 512, 256
    g = rng.uniform(0.01, 1.0, (h, w))
    ls0 = (rng.uniform(size=(h, w)) > 0.5).astype(np.float64)
    got = segment_gac_iterations(jnp.asarray(g), CVParams(), iters=4,
                                 ls0=jnp.asarray(ls0), smoothing=1,
                                 balloon=1, threshold=0.3)
    want = morph_np.morph_gac(g, ls0, 4, 1, 1, 0.3)
    np.testing.assert_array_equal(np.asarray(got.ls), want)
