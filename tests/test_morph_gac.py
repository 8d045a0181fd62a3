"""Morphological geodesic active contour (MorphGAC) family tests.

Golden = an independent numpy transcription of the published scheme
(Marquez-Neila et al., PAMI 2014) written directly in this file with the
framework's replica/Neumann edge convention (ops/morph.py docstring).
As with MorphACWE the binary state makes jnp-vs-numpy equivalence EXACT
in f64 on seeded random inputs (only an attraction-force tie within one
ulp of zero could differ, measure-zero for continuous random data).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.compat import (disk_level_set, inverse_gaussian_gradient,
                              morphological_geodesic_active_contour)
from chan_vese.models.morph_gac import segment_gac, segment_gac_fixed
from chan_vese.ops.morph import gaussian_blur
from chan_vese.ops.morph_np import morph_gac as np_morph_gac
from chan_vese.params import CVParams

from fixtures import iou


def _disk_image(n=96, r=28, lo=20.0, hi=220.0, noise=0.0, seed=0):
    """Bright disk on dark background + the ground-truth mask."""
    i, j = np.ogrid[:n, :n]
    d2 = (i - n / 2) ** 2 + (j - n / 2) ** 2
    gt = d2 < r * r
    img = np.where(gt, hi, lo).astype(np.float64)
    if noise:
        img += np.random.default_rng(seed).normal(0, noise, img.shape)
    return img, gt


# --------------------------------------------------------------------------
# preprocessing
# --------------------------------------------------------------------------

def test_gaussian_blur_matches_scipy_nearest():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (41, 57))
    for sigma in (0.8, 2.0, 5.0):
        want = gaussian_filter(img, sigma, mode="nearest", truncate=4.0)
        got = np.asarray(gaussian_blur(jnp.asarray(img), sigma))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_inverse_gaussian_gradient_properties():
    img, gt = _disk_image()
    g = inverse_gaussian_gradient(img, alpha=100.0, sigma=2.0)
    assert g.shape == img.shape and g.dtype == np.float32
    assert 0.0 < g.min() and g.max() <= 1.0
    # flat regions ~1, the contrast edge well below
    assert g[2, 2] > 0.95 and g[48, 48] > 0.95
    edge = g[48, 48 + 28]            # on the disk boundary
    assert edge < 0.2
    # multichannel: any channel's edge stops the contour
    rgb = np.stack([img, np.full_like(img, 7.0), 0.5 * img], -1)
    g3 = inverse_gaussian_gradient(rgb, alpha=100.0, sigma=2.0)
    assert g3.shape == img.shape
    assert g3[48, 48 + 28] < 0.2 and g3[2, 2] > 0.95


# --------------------------------------------------------------------------
# equivalence vs the golden (exact, f64)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("balloon,smoothing", [(0, 1), (1, 1), (-1, 2),
                                               (1, 0)])
def test_matches_numpy_golden(balloon, smoothing):
    rng = np.random.default_rng(11)
    g = rng.uniform(0.05, 1.0, (40, 56))
    ls0 = (rng.uniform(size=(40, 56)) > 0.5).astype(np.float64)
    want = np_morph_gac(g, ls0, iters=12, smoothing=smoothing,
                        balloon=balloon, threshold=0.4)
    got = segment_gac_fixed(jnp.asarray(g), CVParams(), iters=12,
                            ls0=jnp.asarray(ls0), smoothing=smoothing,
                            balloon=balloon, threshold=0.4)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_chunked_run_matches_whole_run():
    """start_iter keeps the SIoIS/ISoSI alternation across chunks."""
    rng = np.random.default_rng(12)
    g = rng.uniform(0.05, 1.0, (24, 24))
    ls0 = (rng.uniform(size=(24, 24)) > 0.5).astype(np.float64)
    mid = segment_gac_fixed(jnp.asarray(g), CVParams(), iters=3,
                            ls0=jnp.asarray(ls0), balloon=1)
    two = segment_gac_fixed(jnp.asarray(g), CVParams(), iters=4,
                            ls0=mid.ls, balloon=1, start_iter=3)
    whole = segment_gac_fixed(jnp.asarray(g), CVParams(), iters=7,
                              ls0=jnp.asarray(ls0), balloon=1)
    np.testing.assert_array_equal(np.asarray(two.ls), np.asarray(whole.ls))


# --------------------------------------------------------------------------
# segmentation quality + driver behavior
# --------------------------------------------------------------------------

def test_balloon_grows_seed_onto_edge():
    """A small seed inside the object inflates (balloon=+1) until the
    edge map's attraction force pins it to the boundary."""
    img, gt = _disk_image(noise=3.0)
    g = jnp.asarray(inverse_gaussian_gradient(img, alpha=5.0, sigma=2.0),
                    jnp.float64)
    seed = disk_level_set(img.shape, radius=6).astype(np.float64)
    res = segment_gac(g, CVParams(max_iter=300), ls0=jnp.asarray(seed),
                      balloon=1, threshold=0.3)
    assert iou(np.asarray(res.mask), gt) >= 0.95
    assert int(res.iters) < 300     # converged, didn't hit the cap


def test_balloon_shrinks_onto_edge():
    """A too-large init deflates (balloon=-1) onto the object."""
    img, gt = _disk_image(noise=3.0)
    g = jnp.asarray(inverse_gaussian_gradient(img, alpha=5.0, sigma=2.0),
                    jnp.float64)
    seed = disk_level_set(img.shape, radius=44).astype(np.float64)
    res = segment_gac(g, CVParams(max_iter=300), ls0=jnp.asarray(seed),
                      balloon=-1, threshold=0.3)
    assert iou(np.asarray(res.mask), gt) >= 0.95


def test_nan_edge_map_aborts():
    g = np.full((32, 32), 0.9)
    g[3, 3] = np.nan
    res = segment_gac(jnp.asarray(g), CVParams(max_iter=500), balloon=1,
                      threshold=0.3)
    assert int(res.iters) < 500
    assert not np.isfinite(float(res.delta))


# --------------------------------------------------------------------------
# compat surface
# --------------------------------------------------------------------------

def test_compat_matches_golden_auto_threshold():
    rng = np.random.default_rng(13)
    g = rng.uniform(0.05, 1.0, (30, 35))
    thr = float(np.percentile(g, 40))
    want = np_morph_gac(g, disk_level_set(g.shape), iters=9, smoothing=1,
                        balloon=1, threshold=thr)
    got = morphological_geodesic_active_contour(g, num_iter=9,
                                                balloon=1)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want.astype(np.int8))


def test_compat_iter_callback_and_errors():
    rng = np.random.default_rng(14)
    g = rng.uniform(0.05, 1.0, (24, 24))
    states = []
    got = morphological_geodesic_active_contour(
        g, num_iter=5, balloon=-1, iter_callback=states.append)
    assert len(states) == 6
    np.testing.assert_array_equal(states[-1], got)
    fast = morphological_geodesic_active_contour(g, num_iter=5, balloon=-1)
    np.testing.assert_array_equal(got, fast)
    with pytest.raises(ValueError):
        morphological_geodesic_active_contour(g, 5, init_level_set="blob")
    with pytest.raises(ValueError):
        morphological_geodesic_active_contour(
            g, 5, init_level_set=np.zeros((3, 3)))
    with pytest.raises(ValueError):
        morphological_geodesic_active_contour(
            np.zeros((4, 4, 3)), 5)     # edge map must be 2D


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_morph_gac(tmp_path):
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    img, gt = _disk_image(noise=3.0)
    src = tmp_path / "in.npy"
    np.save(src, img.astype(np.float32))
    out = tmp_path / "mask.png"

    # tolerance mode: small-disk seed inflated by the balloon
    rc = main([str(src), "--morph-gac", "--balloon", "1", "--init",
               "small-disk", "--gac-alpha", "5", "--gac-sigma", "2",
               "--gac-threshold", "0.3", "-o", str(out), "--f64",
               "--quiet"])
    assert rc == 0 and out.exists()
    mask = image_io.load_image(str(out)) > 127
    assert iou(mask, gt) >= 0.95

    # fixed mode + evolution gif; sharded tolerance mode on the fake mesh
    gif = tmp_path / "evo.gif"
    rc = main([str(src), "--morph-gac", "--balloon", "1", "--init",
               "small-disk", "--gac-alpha", "5", "--gac-sigma", "2",
               "--gac-threshold", "0.3", "--iters", "40",
               "--evolution-gif", str(gif), "--gif-every", "10",
               "-o", str(out), "--f64", "--quiet"])
    assert rc == 0 and gif.exists()
    rc = main([str(src), "--morph-gac", "--balloon", "1", "--init",
               "small-disk", "--gac-alpha", "5", "--gac-sigma", "2",
               "--gac-threshold", "0.3", "--mesh", "2", "4",
               "-o", str(out), "--f64", "--quiet"])
    assert rc == 0
    mask = image_io.load_image(str(out)) > 127
    assert iou(mask, gt) >= 0.95

    # --morph-gac + --multiphase: gac dropped with a warning, still runs
    rc = main([str(src), "--morph-gac", "--multiphase", "2", "-o",
               str(out), "--f64", "--quiet"])
    assert rc == 0


# --------------------------------------------------------------------------
# sharded (GSPMD over the fake 8-device mesh)
# --------------------------------------------------------------------------

def test_sharded_matches_unsharded_exact():
    """segment_gac_sharded == segment_gac exactly on the binary state
    (2x4 mesh). The GAC loop has NO global reductions, so there isn't
    even a reduction-order tie to worry about - equality is structural."""
    from chan_vese.models.morph_gac import segment_gac_sharded
    from chan_vese.parallel.mesh import make_grid_mesh

    img, gt = _disk_image()
    g = jnp.asarray(inverse_gaussian_gradient(img, alpha=5.0, sigma=2.0),
                    jnp.float64)
    seed = jnp.asarray(disk_level_set(img.shape, radius=6)
                       .astype(np.float64))
    mesh = make_grid_mesh(2, 4)
    want = segment_gac(g, CVParams(max_iter=300), ls0=seed, balloon=1,
                       threshold=0.3)
    got = segment_gac_sharded(g, CVParams(max_iter=300), mesh=mesh,
                              ls0=seed, balloon=1, threshold=0.3)
    np.testing.assert_array_equal(np.asarray(got.ls), np.asarray(want.ls))
    assert int(got.iters) == int(want.iters)
    assert len(got.ls.sharding.device_set) == 8
    with pytest.raises(ValueError):
        segment_gac_sharded(g[:95], CVParams(), mesh=mesh)
    with pytest.raises(ValueError):
        segment_gac_sharded(g, CVParams())


# --------------------------------------------------------------------------
# on the GPU (marked gpu; skipped without one)
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_gac_gpu_matches_cpu_masks(gpu):
    """Compiled f32 on the GPU converges to the same mask as the f64
    golden on a clean synthetic."""
    img, gt = _disk_image(n=256, r=80, noise=3.0)
    g32 = inverse_gaussian_gradient(img.astype(np.float32), alpha=5.0,
                                    sigma=2.0)
    seed = disk_level_set(img.shape, radius=20).astype(np.float32)
    res = segment_gac(jax.device_put(g32, gpu), CVParams(max_iter=400),
                      ls0=jax.device_put(seed, gpu), balloon=1,
                      threshold=0.3)
    m = np.asarray(res.mask)
    assert iou(m, gt) >= 0.97
    want = np_morph_gac(g32.astype(np.float64), seed, iters=int(res.iters),
                        smoothing=1, balloon=1, threshold=0.3)
    # f32-vs-f64 attraction-sign ties could flip isolated contour pixels
    assert (m == (want > 0.5)).mean() >= 0.999


def test_lean_iterations_driver_matches_traced():
    """segment_gac_iterations (the bench/raw-throughput path) runs the
    exact trajectory of segment_gac_fixed, including the alternation
    offset."""
    from chan_vese.models.morph_gac import segment_gac_iterations

    rng = np.random.default_rng(2)
    g = jnp.asarray(rng.uniform(0.05, 1.0, (48, 64)))
    a = segment_gac_iterations(g, CVParams(), iters=11, balloon=1,
                               threshold=0.4, start_iter=3)
    b = segment_gac_fixed(g, CVParams(), iters=11, balloon=1,
                          threshold=0.4, start_iter=3)
    np.testing.assert_array_equal(np.asarray(a.ls), np.asarray(b.ls))
