"""Communication-avoiding sharded morph/GAC (parallel/sharded_morph.py)
and the tolerance-mode morphological drivers.

Equivalence discipline: the state is binary {0,1}, so the GAC chunked
paths are BITWISE the per-iteration trajectory (no reductions in the
loop body); ACWE comm_k=1 is bitwise the published per-iteration-means
scheme; ACWE comm_k>1 is the frozen-means-per-chunk trajectory class,
pinned here against the numpy transcription (ops/morph_np.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.models.morph import segment_morph, segment_morph_fixed
from chan_vese.models.morph_gac import segment_gac, segment_gac_fixed
from chan_vese.ops import morph_np
from chan_vese.ops.morph import inverse_gaussian_gradient
from chan_vese.parallel.mesh import make_grid_mesh
from chan_vese.parallel.sharded_morph import (
    segment_gac_sharded_chunked, segment_morph_sharded_chunked)
from chan_vese.params import CVParams


def _disk_image(H=96, W=128, r=30, noise=5.0, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W))
    yy, xx = np.mgrid[:H, :W]
    img[(yy - H // 2) ** 2 + (xx - W // 2) ** 2 < r ** 2] = 200.0
    img += rng.normal(0, noise, img.shape)
    return jnp.asarray(img)


def _edge_disk(H=96, W=128):
    """Disk overlapping the image boundary: exercises the global-edge
    pad refresh (the contour crosses shard AND image edges)."""
    img = np.zeros((H, W))
    yy, xx = np.mgrid[:H, :W]
    img[(yy - 8) ** 2 + (xx - 10) ** 2 < 40 ** 2] = 200.0
    return jnp.asarray(img + 0.1 * np.arange(W)[None, :])


# --------------------------------------------------------------------------
# comm_k sharded GAC: bitwise for any comm_k
# --------------------------------------------------------------------------

@pytest.mark.parametrize("comm_k,balloon", [(4, 1), (8, -1), (3, 1),
                                            (5, 0)])
def test_gac_sharded_chunked_bitwise(comm_k, balloon):
    u = _disk_image()
    g = inverse_gaussian_gradient(u, alpha=5.0, sigma=3.0)
    mesh = make_grid_mesh(2, 4)
    p = CVParams(max_iter=37, tol=0.0)  # tol=0: run the exact cap
    got = segment_gac_sharded_chunked(g, p, mesh=mesh, smoothing=1,
                                      balloon=balloon, threshold=0.3,
                                      comm_k=comm_k)
    want = segment_gac_fixed(g, p, iters=37, smoothing=1,
                             balloon=balloon, threshold=0.3)
    assert int(got.iters) == 37
    np.testing.assert_array_equal(np.asarray(got.ls), np.asarray(want.ls))


def test_gac_sharded_chunked_edge_disk_bitwise():
    """Contour crossing image edges: the per-iteration global-pad
    refresh must reproduce clamped-shift semantics exactly."""
    u = _edge_disk()
    g = inverse_gaussian_gradient(u, alpha=5.0, sigma=2.0)
    mesh = make_grid_mesh(2, 4)
    p = CVParams(max_iter=24, tol=0.0)
    got = segment_gac_sharded_chunked(g, p, mesh=mesh, smoothing=1,
                                      balloon=1, threshold=0.3, comm_k=6)
    want = segment_gac_fixed(g, p, iters=24, smoothing=1, balloon=1,
                             threshold=0.3)
    np.testing.assert_array_equal(np.asarray(got.ls), np.asarray(want.ls))


def test_gac_sharded_chunked_tolerance_stops_early():
    u = _disk_image(noise=0.0)
    g = inverse_gaussian_gradient(u, alpha=5.0, sigma=3.0)
    mesh = make_grid_mesh(2, 2)
    p = CVParams(max_iter=400, tol=1e-4, patience=4, min_iter=8)
    res = segment_gac_sharded_chunked(g, p, mesh=mesh, smoothing=1,
                                      balloon=1, threshold=0.3, comm_k=4)
    assert int(res.iters) < 400
    assert float(res.delta) < 1e-4


# --------------------------------------------------------------------------
# comm_k sharded ACWE
# --------------------------------------------------------------------------

def test_morph_sharded_chunked_k1_bitwise():
    """comm_k=1 == the published per-iteration-means scheme bitwise."""
    u = _disk_image()
    mesh = make_grid_mesh(2, 4)
    p = CVParams(max_iter=40, tol=0.0)
    got = segment_morph_sharded_chunked(u, p, mesh=mesh, smoothing=1,
                                        comm_k=1)
    want = segment_morph_fixed(u, p, iters=40, smoothing=1)
    np.testing.assert_array_equal(np.asarray(got.ls), np.asarray(want.ls))


def test_morph_sharded_chunked_matches_numpy_frozen_means():
    """comm_k=4 sharded == the numpy frozen-means-per-chunk ACWE
    transcription on the same seeded image (shard_map + deep halos vs
    a plain whole-image loop)."""
    u = _disk_image(seed=3)
    mesh = make_grid_mesh(2, 4)
    p = CVParams(max_iter=32, tol=0.0)
    got = segment_morph_sharded_chunked(u, p, mesh=mesh, smoothing=1,
                                        comm_k=4)
    want = morph_np.morph_acwe(np.asarray(u), _ls0(u, p), 32, 1, k=4)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_morph_sharded_chunked_rgb():
    """(H, W, C) with per-channel lambdas: frozen-means chunks vs the
    per-iteration GSPMD driver's converged mask."""
    rng = np.random.default_rng(5)
    H, W = 96, 128
    img = np.zeros((H, W, 3))
    yy, xx = np.mgrid[:H, :W]
    disk = (yy - 48) ** 2 + (xx - 64) ** 2 < 28 ** 2
    img[disk] = (180.0, 120.0, 60.0)
    img += rng.normal(0, 4, img.shape)
    u = jnp.asarray(img)
    mesh = make_grid_mesh(2, 2)
    p = CVParams(max_iter=40, tol=0.0)
    got = segment_morph_sharded_chunked(u, p, mesh=mesh, smoothing=1,
                                        comm_k=4,
                                        lambda1=(1.0, 1.0, 2.0),
                                        lambda2=(1.0, 1.0, 1.0))
    want = segment_morph_fixed(u, p, iters=40, smoothing=1,
                               lambda1=(1.0, 1.0, 2.0),
                               lambda2=(1.0, 1.0, 1.0))
    inter = jnp.sum(got.mask & want.mask)
    union = jnp.sum(got.mask | want.mask)
    assert float(inter / union) > 0.99


def test_morph_sharded_chunked_nan_aborts():
    u = _disk_image().at[10, 10].set(jnp.nan)
    mesh = make_grid_mesh(2, 2)
    p = CVParams(max_iter=100, tol=1e-4, patience=3)
    res = segment_morph_sharded_chunked(u, p, mesh=mesh, comm_k=4)
    assert int(res.iters) <= 8  # aborted after the first divergent check
    assert not bool(jnp.isfinite(res.delta))


def test_chunked_rejects_bad_geometry():
    u = _disk_image(96, 128)
    mesh = make_grid_mesh(2, 4)
    with pytest.raises(ValueError, match="halo depth"):
        # reach 3 * comm_k 16 = 48 > local 96/2 = 48? no - cols: 128/4=32
        segment_morph_sharded_chunked(u, CVParams(), mesh=mesh, comm_k=16)
    with pytest.raises(ValueError, match="divisible"):
        segment_morph_sharded_chunked(u[:95], CVParams(), mesh=mesh,
                                      comm_k=2)


# --------------------------------------------------------------------------
# tolerance-mode drivers (single device)
# --------------------------------------------------------------------------

def test_segment_morph_tolerance_matches_fixed_run():
    """segment_morph stops on the flip metric; its state equals the
    fixed-iteration trace driver and the numpy transcription at the
    iteration it stopped, and max_iter caps exactly."""
    u = _disk_image()
    p = CVParams(max_iter=100, tol=1e-4, patience=4, min_iter=8)
    got = segment_morph(u, p, smoothing=1)
    n = int(got.iters)
    assert 8 <= n < 100
    want = segment_morph_fixed(u, p, iters=n, smoothing=1)
    np.testing.assert_array_equal(np.asarray(got.ls), np.asarray(want.ls))
    np.testing.assert_array_equal(
        np.asarray(got.ls), morph_np.morph_acwe(np.asarray(u), _ls0(u, p),
                                                n, 1))
    got0 = segment_morph(u, CVParams(max_iter=33, tol=0.0), smoothing=1)
    assert int(got0.iters) == 33


def test_segment_gac_tolerance_matches_numpy():
    u = _disk_image(noise=0.0)
    g = inverse_gaussian_gradient(u, alpha=5.0, sigma=3.0)
    p = CVParams(max_iter=200, tol=1e-4, patience=4, min_iter=8)
    got = segment_gac(g, p, smoothing=1, balloon=1, threshold=0.3)
    n = int(got.iters)
    assert n < 200
    want = morph_np.morph_gac(np.asarray(g), _ls0(u, p), n, 1, 1, 0.3)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_segment_morph_rgb_nan_aborts():
    u = jnp.stack([_disk_image()] * 3, axis=-1).at[5, 5, 1].set(jnp.nan)
    p = CVParams(max_iter=100, tol=1e-4, patience=3)
    res = segment_morph(u, p)
    assert not bool(jnp.isfinite(res.delta))
    assert int(res.iters) <= 2


def test_sharded_wrappers_pin_jnp_route():
    """The GSPMD wrapper runs the unsharded driver's program on sharded
    arrays: same binary state on a 2x2 mesh."""
    u = _disk_image()
    mesh = make_grid_mesh(2, 2)
    from chan_vese.models.morph import segment_morph_sharded
    res = segment_morph_sharded(u, CVParams(max_iter=30), mesh=mesh)
    ref = segment_morph(u, CVParams(max_iter=30))
    np.testing.assert_array_equal(np.asarray(res.ls), np.asarray(ref.ls))


def test_cli_morph_comm_k(tmp_path):
    """--morph/--morph-gac + --mesh + --comm-k routes the chunked
    communication-avoiding drivers (masks match the comm_k=1 path)."""
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    u = np.asarray(_disk_image(noise=3.0))
    src = tmp_path / "in.npy"
    np.save(src, u.astype(np.float32))
    out1 = tmp_path / "m1.png"
    outk = tmp_path / "mk.png"
    base = [str(src), "--morph", "--init", "checkerboard", "--f64",
            "--quiet", "--mesh", "2", "4"]
    assert main(base + ["-o", str(out1)]) == 0
    assert main(base + ["-o", str(outk), "--comm-k", "4"]) == 0
    m1 = image_io.load_image(str(out1)) > 127
    mk = image_io.load_image(str(outk)) > 127
    assert float(np.sum(m1 & mk) / np.sum(m1 | mk)) > 0.99

    outg = tmp_path / "g.png"
    rc = main([str(src), "--morph-gac", "--balloon", "1", "--init",
               "small-disk", "--gac-alpha", "5", "--gac-sigma", "2",
               "--gac-threshold", "0.3", "--mesh", "2", "4",
               "--comm-k", "4", "-o", str(outg), "--f64", "--quiet"])
    assert rc == 0
    mg = image_io.load_image(str(outg)) > 127
    assert mg.any() and not mg.all()


# --------------------------------------------------------------------------
# chunked sharded drivers against the numpy transcription
# --------------------------------------------------------------------------

def _ls0(u, p):
    return np.asarray(segment_morph_fixed(u, p, iters=0).ls)


def test_morph_chunked_wide_shards_match_numpy():
    """64-column shards of a 96x256 image on the 2x4 mesh."""
    u = _disk_image(H=96, W=256)
    p = CVParams(max_iter=12, tol=0.0)
    got = segment_morph_sharded_chunked(u, p, mesh=make_grid_mesh(2, 4),
                                        comm_k=4)
    want = morph_np.morph_acwe(np.asarray(u), _ls0(u, p), 12, 1, k=4)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_morph_chunked_edge_disk_matches_numpy():
    """Contour crossing image edges: global-edge shards refresh their
    pads on all four sides."""
    u = _edge_disk(96, 128)
    p = CVParams(max_iter=16, tol=0.0)
    got = segment_morph_sharded_chunked(u, p, mesh=make_grid_mesh(2, 2),
                                        comm_k=4)
    want = morph_np.morph_acwe(np.asarray(u), _ls0(u, p), 16, 1, k=4)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_gac_chunked_matches_numpy():
    """GAC chunks == the numpy per-iteration transcription bitwise."""
    u = _disk_image()
    g = inverse_gaussian_gradient(u, alpha=5.0, sigma=3.0)
    p = CVParams(max_iter=12, tol=0.0)
    got = segment_gac_sharded_chunked(g, p, mesh=make_grid_mesh(2, 4),
                                      smoothing=1, balloon=1,
                                      threshold=0.3, comm_k=4)
    want = morph_np.morph_gac(np.asarray(g), _ls0(u, p), 12, 1, 1, 0.3)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_chunked_remainder_matches_numpy():
    """max_iter % comm_k != 0: two full chunks plus a remainder of 3."""
    u = _disk_image()
    g = inverse_gaussian_gradient(u, alpha=5.0, sigma=3.0)
    p = CVParams(max_iter=11, tol=0.0)
    got = segment_gac_sharded_chunked(g, p, mesh=make_grid_mesh(2, 2),
                                      balloon=1, threshold=0.3, comm_k=4)
    assert int(got.iters) == 11
    want = morph_np.morph_gac(np.asarray(g), _ls0(u, p), 11, 1, 1, 0.3)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_morph_chunked_odd_comm_k_matches_numpy():
    """An odd comm_k x smoothing (the smoothing alternation changes
    phase between chunks) keeps the global call counter exact."""
    u = _disk_image()
    p = CVParams(max_iter=9, tol=0.0)
    got = segment_morph_sharded_chunked(u, p, mesh=make_grid_mesh(2, 4),
                                        comm_k=3)
    want = morph_np.morph_acwe(np.asarray(u), _ls0(u, p), 9, 1, k=3)
    np.testing.assert_array_equal(np.asarray(got.ls), want)
