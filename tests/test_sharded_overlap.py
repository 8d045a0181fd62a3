"""Halo-comm / interior-compute overlap tests (parallel/sharded.py
_overlap_new; SURVEY.md §2.9 PP-analog row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.ops import sweep_np
from chan_vese.params import CVParams
from chan_vese.parallel import mesh as meshmod
from chan_vese.parallel.sharded import segment_sharded
from fixtures import two_disks

F32 = jnp.float32


@pytest.fixture(scope="module")
def grid_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (fake) devices")
    return meshmod.make_grid_mesh(2, 4)


def test_overlap_single_iteration_bitwise(grid_mesh):
    """ONE overlapped iteration == exchange-then-sweep, bitwise: the
    stitched rim strips and the interior compute reproduce the padded
    sweep exactly (same elementwise ops on the same values)."""
    img, _ = two_disks(48, 96, noise=6.0)  # 24x24 shards on the 2x4 mesh
    u0 = jnp.asarray(img, F32)
    p = CVParams(max_iter=1, tol=-1.0, min_iter=0)
    res_std = segment_sharded(u0, p, grid_mesh, fixed=True, max_iter=1)
    res_ovl = segment_sharded(u0, p, grid_mesh, fixed=True, max_iter=1,
                              halo="overlap")
    np.testing.assert_array_equal(np.asarray(res_std.phi),
                                  np.asarray(res_ovl.phi))


def test_overlap_equals_standard_end_to_end(grid_mesh):
    """Multi-iteration agreement is ulp-class, not bitwise: the psum'd
    partials fuse differently in the two compiled programs, so c1/c2
    (and hence phi) drift at f32 reduction-order level from iteration 2
    on - the same equivalence class models/resident.py documents."""
    img, _ = two_disks(48, 96, noise=6.0)
    u0 = jnp.asarray(img, F32)
    p = CVParams(max_iter=15, tol=-1.0, min_iter=0)
    res_std = segment_sharded(u0, p, grid_mesh, fixed=True, max_iter=15)
    res_ovl = segment_sharded(u0, p, grid_mesh, fixed=True, max_iter=15,
                              halo="overlap")
    np.testing.assert_allclose(np.asarray(res_std.phi),
                               np.asarray(res_ovl.phi),
                               rtol=1e-3, atol=5e-2)
    np.testing.assert_array_equal(np.asarray(res_std.mask),
                                  np.asarray(res_ovl.mask))


def test_overlap_tolerance_mode(grid_mesh):
    img, gt = two_disks(48, 96, noise=6.0)
    u0 = jnp.asarray(img, F32)
    p = CVParams(tol=1e-4, max_iter=200, min_iter=5)
    res = segment_sharded(u0, p, grid_mesh, halo="overlap")
    from fixtures import iou
    assert iou(np.asarray(res.mask), gt) > 0.98
    assert int(res.iters) < 200


def test_overlap_validation(grid_mesh):
    # shards below 16x16 are rejected (16-deep strips would wrap)
    u_small = jnp.zeros((16, 32), F32)  # 8x8 shards
    with pytest.raises(ValueError, match="16x16"):
        segment_sharded(u_small, CVParams(), grid_mesh, halo="overlap")


def _phi0(shape, p):
    from chan_vese.utils.init_phi import init_phi
    return np.asarray(init_phi(shape, p.init, jnp.float64))


def test_overlap_single_iteration_matches_numpy(grid_mesh):
    """One overlap iteration (interior from owned data, rim from the
    exchanged strips) == the unsharded numpy red-black iteration."""
    img, _ = two_disks(48, 96, noise=6.0)  # 24x24 shards on the 2x4 mesh
    p = CVParams()
    ovl = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=1, halo="overlap")
    want, _, _, _ = sweep_np.segment_fixed(img, p, 1, _phi0((48, 96), p))
    np.testing.assert_allclose(np.asarray(ovl.phi), want, rtol=1e-10,
                               atol=1e-10)


def test_overlap_end_to_end_matches_numpy(grid_mesh):
    """15 overlap iterations stay on the numpy trajectory."""
    img, _ = two_disks(48, 96, noise=6.0)
    p = CVParams()
    ovl = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=15, halo="overlap")
    want, _, _, _ = sweep_np.segment_fixed(img, p, 15, _phi0((48, 96), p))
    np.testing.assert_allclose(np.asarray(ovl.phi), want, rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_array_equal(np.asarray(ovl.mask), want >= 0)


def test_overlap_commk_single_chunk_bitwise(grid_mesh):
    """ONE overlap x comm_k chunk (jnp interior) == the standard comm_k
    chunk path, bitwise: interior iterations see only owned data and the
    strips recompute the rim from the same exchanged values."""
    img, _ = two_disks(48, 96, noise=6.0)
    u0 = jnp.asarray(img)  # f64
    p = CVParams()
    std = segment_sharded(u0, p, grid_mesh, fixed=True, max_iter=3,
                          comm_k=3)
    ovl = segment_sharded(u0, p, grid_mesh, fixed=True, max_iter=3,
                          comm_k=3, halo="overlap")
    np.testing.assert_array_equal(np.asarray(std.phi), np.asarray(ovl.phi))


def test_overlap_commk_multi_chunk_class(grid_mesh):
    """Several chunks + remainder stay on the frozen-means trajectory."""
    img, gt = two_disks(48, 96, noise=6.0)
    u0 = jnp.asarray(img, F32)
    p = CVParams(tol=1e-4, max_iter=200, min_iter=4)
    res = segment_sharded(u0, p, grid_mesh, comm_k=4, halo="overlap")
    from fixtures import iou
    assert iou(np.asarray(res.mask), gt) > 0.98
    assert int(res.iters) < 200


def test_overlap_commk_wide_matches_numpy(grid_mesh):
    """Overlap x comm_k on 24x64 shards == the numpy frozen-means
    chunk (interior rows 4k up/left and 2k down/right of the rim come
    from local data, the rim from the deep exchange)."""
    img, _ = two_disks(48, 256, noise=6.0)
    p = CVParams()
    ovl = segment_sharded(jnp.asarray(img), p, grid_mesh, fixed=True,
                          max_iter=4, comm_k=2, halo="overlap")
    want = sweep_np.segment_chunked(img, p, 4, _phi0((48, 256), p), 2)
    np.testing.assert_allclose(np.asarray(ovl.phi), want, rtol=1e-9,
                               atol=1e-9)
