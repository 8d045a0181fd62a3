"""Communication-avoiding sharded chunking (segment_sharded(comm_k=k)):
one 4k-deep halo exchange per k frozen-means iterations, checked against
the unsharded f64 numpy references of ops/sweep_np.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.ops import sweep_np
from chan_vese.params import CVParams
from chan_vese.parallel import mesh as meshmod
from chan_vese.parallel.sharded import segment_sharded
from chan_vese.utils.init_phi import init_phi
from fixtures import iou, two_disks

F32 = jnp.float32


@pytest.fixture(scope="module")
def grid_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (fake) devices")
    return meshmod.make_grid_mesh(2, 4)


def _phi0(shape, p):
    return np.asarray(init_phi(shape, p.init, jnp.float64))


def _rgb(img, seed):
    rng = np.random.default_rng(seed)
    return np.stack([img + rng.normal(0, 2.0, img.shape)
                     for _ in range(3)], axis=-1)


def _check(res, want, tol=1e-9):
    np.testing.assert_allclose(np.asarray(res.phi), want, rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(np.asarray(res.mask), want >= 0)


@pytest.mark.parametrize("k,iters", [(2, 8), (3, 10)])
def test_commk_matches_frozen_means_reference(grid_mesh, k, iters):
    img, _ = two_disks(48, 96, noise=6.0)
    u0 = jnp.asarray(img)  # f64 in tests: tight trajectory agreement
    p = CVParams()
    res = segment_sharded(u0, p, grid_mesh, fixed=True, max_iter=iters,
                          comm_k=k)
    want = sweep_np.segment_chunked(img, p, iters, _phi0((48, 96), p), k)
    _check(res, want)
    assert int(res.iters) == iters


@pytest.mark.parametrize("k,iters", [(2, 8), (3, 10)])
def test_commk_overlap_matches_frozen_means_numpy(grid_mesh, k, iters):
    """overlap x comm_k (interior chunk from local data while the deep
    exchange runs, then rim strips) is the same frozen-means class."""
    img, _ = two_disks(64, 128, noise=6.0)
    p = CVParams()
    res = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=iters, comm_k=k, halo="overlap")
    _check(res, sweep_np.segment_chunked(img, p, iters,
                                         _phi0((64, 128), p), k))


@pytest.mark.parametrize("k,iters", [(2, 8), (4, 10)])
def test_commk_wide_image_matches_numpy(grid_mesh, k, iters):
    """48x256 over the 2x4 mesh (24x64 shards); iters=10 with k=4 covers
    the remainder chunk."""
    img, _ = two_disks(48, 256, noise=6.0)
    p = CVParams()
    res = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=iters, comm_k=k)
    _check(res, sweep_np.segment_chunked(img, p, iters,
                                         _phi0((48, 256), p), k))


def test_per_iteration_sharded_matches_numpy(grid_mesh):
    """comm_k = 1 is the per-iteration path: means refreshed after every
    sweep, i.e. the numpy segment_fixed trajectory."""
    img, _ = two_disks(48, 96, noise=6.0)
    p = CVParams()
    res = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=12)
    want, _, _, _ = sweep_np.segment_fixed(img, p, 12, _phi0((48, 96), p))
    _check(res, want)


@pytest.mark.parametrize("per_channel", [False, True])
def test_commk_vec_matches_reference(grid_mesh, per_channel):
    """Vector-valued comm_k chunking, broadcast and per-channel lambdas."""
    img, _ = two_disks(48, 96, noise=6.0)
    u0 = _rgb(img, 3)
    lam1, lam2 = ((1.0, 1.2, 0.8), (1.0, 0.9, 1.1)) if per_channel \
        else (None, None)
    p = CVParams()
    res = segment_sharded(jnp.asarray(u0), p, grid_mesh, fixed=True,
                          max_iter=8, comm_k=2, lambda1=lam1, lambda2=lam2)
    _check(res, sweep_np.segment_chunked(u0, p, 8, _phi0((48, 96), p), 2,
                                         lam1, lam2))


def test_commk_vec_wide_matches_numpy(grid_mesh):
    img, _ = two_disks(48, 256, noise=6.0)
    u0 = _rgb(img, 5)
    lam1, lam2 = (1.0, 1.2, 0.8), (1.0, 0.9, 1.1)
    p = CVParams()
    res = segment_sharded(jnp.asarray(u0), p, grid_mesh, fixed=True,
                          max_iter=8, comm_k=2, lambda1=lam1, lambda2=lam2)
    _check(res, sweep_np.segment_chunked(u0, p, 8, _phi0((48, 256), p), 2,
                                         lam1, lam2))


def test_vec_per_iteration_matches_numpy(grid_mesh):
    """comm_k == 1 vector sharding: per-iteration per-channel means."""
    img, _ = two_disks(48, 256, noise=6.0)
    u0 = _rgb(img, 7)
    p = CVParams()
    res = segment_sharded(jnp.asarray(u0), p, grid_mesh, fixed=True,
                          max_iter=6)
    want, _, _, _ = sweep_np.segment_fixed(u0, p, 6, _phi0((48, 256), p))
    _check(res, want)


@pytest.mark.parametrize("channels", [1, 4])
def test_commk_vec_channel_counts(grid_mesh, channels):
    rng = np.random.default_rng(channels)
    img, _ = two_disks(48, 96, noise=6.0)
    u0 = np.stack([img + rng.normal(0, 3.0, img.shape)
                   for _ in range(channels)], axis=-1)
    p = CVParams()
    res = segment_sharded(jnp.asarray(u0), p, grid_mesh, fixed=True,
                          max_iter=7, comm_k=3)
    _check(res, sweep_np.segment_chunked(u0, p, 7, _phi0((48, 96), p), 3))


def test_commk_odd_shard_rows_match_numpy(grid_mesh):
    """30-row, 24-col shards (no alignment to any tile size)."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 255, (60, 96))
    p = CVParams()
    res = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=6, comm_k=2)
    _check(res, sweep_np.segment_chunked(img, p, 6, _phi0((60, 96), p), 2))


def test_commk_remainder_chunk_matches_numpy(grid_mesh):
    img, _ = two_disks(48, 96, noise=6.0)
    p = CVParams(init="circle")
    res = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=7, comm_k=4)
    assert int(res.iters) == 7
    _check(res, sweep_np.segment_chunked(img, p, 7, _phi0((48, 96), p), 4))


def test_commk_means_match_numpy(grid_mesh):
    """The returned c1/c2 are the region means of the final phi."""
    img, _ = two_disks(48, 96, noise=6.0)
    p = CVParams()
    res = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=8, comm_k=4)
    c1, c2 = sweep_np.region_means(img, np.asarray(res.phi), p.eps)
    np.testing.assert_allclose([float(res.c1), float(res.c2)], [c1, c2],
                               rtol=1e-10)


def test_commk_tolerance_converges(grid_mesh):
    img, gt = two_disks(48, 96, noise=6.0)
    u0 = jnp.asarray(img, F32)
    p = CVParams(tol=1e-4, max_iter=200, min_iter=4)
    res = segment_sharded(u0, p, grid_mesh, comm_k=4)
    assert iou(np.asarray(res.mask), gt) > 0.98
    assert int(res.iters) < 200


def test_commk_validation(grid_mesh):
    p = CVParams()
    u0 = jnp.zeros((48, 96), F32)
    with pytest.raises(ValueError, match="comm_k"):
        segment_sharded(u0, p, grid_mesh, comm_k=0)
    with pytest.raises(ValueError, match="no reinit"):
        segment_sharded(u0, CVParams(reinit_every=5), grid_mesh, comm_k=2)
    with pytest.raises(ValueError, match="grayscale only"):
        segment_sharded(jnp.zeros((48, 96, 3), F32), p, grid_mesh,
                        comm_k=2, halo="overlap")
    with pytest.raises(ValueError, match="deep halos"):
        segment_sharded(u0, p, grid_mesh, comm_k=8)  # 32 > 24-row shard


def test_cli_commk(grid_mesh, tmp_path):
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    img, gt = two_disks(48, 96, noise=6.0)
    pth = tmp_path / "in.png"
    image_io._save_u8(pth, np.clip(img, 0, 255).astype(np.uint8))
    out = tmp_path / "m.png"
    rc = main([str(pth), "--mesh", "2", "4", "--comm-k", "4",
               "--init", "circle", "--quiet", "-o", str(out)])
    assert rc == 0
    mask = image_io.load_image(out) > 127
    assert iou(mask, gt) >= 0.97


@pytest.mark.parametrize("k,iters", [(2, 8), (4, 10)])
def test_commk_even_shards_match_numpy(grid_mesh, k, iters):
    """64x256 over the 2x4 mesh (32x64 shards), remainder chunk at
    k=4."""
    img, _ = two_disks(64, 256, noise=6.0)
    p = CVParams()
    res = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=iters, comm_k=k)
    _check(res, sweep_np.segment_chunked(img, p, iters,
                                         _phi0((64, 256), p), k))


def test_commk_tolerance_stops_on_chunk_boundary(grid_mesh):
    """Tolerance mode checks convergence once per chunk, so a converged
    run stops on a multiple of comm_k."""
    img, _ = two_disks(48, 96, noise=6.0)
    p = CVParams(tol=1e-4, max_iter=203, min_iter=4)
    res = segment_sharded(jnp.asarray(img, F32), p, grid_mesh, comm_k=4)
    n = int(res.iters)
    assert n < 203 and n % 4 == 0


@pytest.mark.parametrize("trial", range(3))
def test_commk_random_matches_numpy(grid_mesh, trial):
    """Random params x random shard geometry x random phi0, with a
    remainder chunk: the sharded chunks == the numpy reference."""
    rng = np.random.default_rng(700 + trial)
    k = int(rng.choice([2, 3]))
    h = int(rng.choice([24, 32, 40, 48]))
    w = int(rng.choice([24, 32, 64, 96]))
    H, W = 2 * h, 4 * w
    p = CVParams(mu=float(rng.uniform(10, 2000)),
                 nu=float(rng.uniform(-50, 50)),
                 lambda1=float(rng.uniform(0.3, 3.0)),
                 lambda2=float(rng.uniform(0.3, 3.0)),
                 dt=float(rng.uniform(0.1, 2.0)),
                 eps=float(rng.uniform(0.3, 3.0)))
    u0 = rng.uniform(0, 255, (H, W))
    phi0 = rng.standard_normal((H, W)) * rng.uniform(0.5, 50)
    iters = 2 * k + 1  # forces a remainder chunk
    res = segment_sharded(jnp.asarray(u0), p, grid_mesh, fixed=True,
                          max_iter=iters, comm_k=k,
                          phi0=jnp.asarray(phi0))
    want = sweep_np.segment_chunked(u0, p, iters, phi0, k)
    scale = float(np.max(np.abs(want))) + 1.0
    np.testing.assert_allclose(np.asarray(res.phi), want, rtol=1e-9,
                               atol=1e-9 * scale,
                               err_msg=f"h={h} w={w} k={k} p={p}")
