"""Coarse-to-fine pyramid driver tests (models/pyramid.py).

The pyramid is a rebuild-side capability (the empty reference mount
publishes none - SURVEY.md Section 0): per-level convergence runs the
standard L3 drivers, so these tests pin (a) the level-planning /
resampling algebra exactly, (b) that the warm-started finest level lands
in the same basin as a direct run (mask IoU), and (c) that the warm start
actually SAVES finest-level iterations - the point of the feature.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese import CVParams
from chan_vese.models.pyramid import (downsample2x, plan_levels,
                                      segment_pyramid,
                                      segment_pyramid_multiphase,
                                      upsample_phi2x)
from chan_vese.models.scalar import segment
from fixtures import colored_squares, four_regions, iou, two_disks

F64 = jnp.float64


@pytest.fixture(scope="module")
def grid_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (fake) devices")
    from chan_vese.parallel import mesh as meshmod
    return meshmod.make_grid_mesh(2, 4)


# ---------------------------------------------------------------- algebra

def test_plan_levels_auto_respects_min_dim_and_divisibility():
    assert plan_levels(512, 512, min_dim=128) == 2   # 512 -> 256 -> 128
    assert plan_levels(512, 512, min_dim=256) == 1
    assert plan_levels(2160, 3840, min_dim=128) == 4  # 2160/16=135 odd next
    assert plan_levels(100, 100, min_dim=128) == 0    # already < 2*min_dim
    # odd dimension blocks decimation entirely
    assert plan_levels(511, 512, min_dim=4) == 0


def test_plan_levels_explicit_is_clipped_not_trusted():
    assert plan_levels(512, 512, levels=1, min_dim=128) == 1
    assert plan_levels(512, 512, levels=99, min_dim=128) == 2
    assert plan_levels(512, 512, levels=0, min_dim=128) == 0
    assert plan_levels(512, 512, levels=-3, min_dim=128) == 0


def test_downsample2x_is_exact_mean_pooling():
    x = jnp.arange(4 * 6, dtype=F64).reshape(4, 6)
    y = downsample2x(x)
    assert y.shape == (2, 3)
    expect = np.asarray(x).reshape(2, 2, 3, 2).mean(axis=(1, 3))
    np.testing.assert_allclose(np.asarray(y), expect, rtol=0, atol=0)


def test_downsample2x_multichannel_and_odd_rejection():
    x = jnp.ones((8, 8, 3), F64) * jnp.arange(3, dtype=F64)
    y = downsample2x(x)
    assert y.shape == (4, 4, 3)
    np.testing.assert_allclose(np.asarray(y),
                               np.ones((4, 4, 3)) * np.arange(3))
    with pytest.raises(ValueError):
        downsample2x(jnp.ones((7, 8), F64))


def test_upsample_phi2x_doubles_shape_and_sdf_scale():
    # an exact linear ramp (gradient-1 SDF analog) upsamples to the exact
    # gradient-1 ramp of the finer grid up to the boundary half-cells
    i = jnp.arange(16, dtype=F64)
    phi = jnp.broadcast_to(i[:, None], (16, 16))
    up = upsample_phi2x(phi)
    assert up.shape == (32, 32)
    interior = np.asarray(up)[2:-2, 2:-2]
    d = np.diff(interior, axis=0)
    np.testing.assert_allclose(d, 1.0, atol=1e-9)


# ------------------------------------------------------------- end-to-end

def test_pyramid_matches_direct_mask_two_disks():
    # circle init pins the orientation of the phi -> -phi symmetric pair
    # of fixed points at every level (the checkerboard can land either
    # orientation, resolution-dependently - same convention as the other
    # tolerance-mode gt tests)
    img, gt = two_disks(256, 256, noise=8.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    direct = segment(u, p)
    pyr = segment_pyramid(u, p, min_dim=32)
    assert len(pyr.level_iters) >= 2
    assert iou(np.asarray(pyr.mask), gt) >= 0.98
    assert iou(np.asarray(pyr.mask), np.asarray(direct.mask)) >= 0.98


def test_pyramid_saves_finest_level_iterations():
    """The warm start must cut full-resolution work vs a cold start -
    the reason the feature exists."""
    img, _ = two_disks(256, 256, noise=8.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    direct = segment(u, p)
    pyr = segment_pyramid(u, p, min_dim=32)
    assert int(pyr.iters) < int(direct.iters)
    # total fine-equivalent work (level pixels weighted) is also lower
    total = sum(n * 0.25 ** lvl
                for lvl, n in enumerate(reversed(pyr.level_iters)))
    assert total < int(direct.iters)


def test_pyramid_levels_zero_is_plain_segment():
    img, _ = two_disks(64, 64, noise=5.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    direct = segment(u, p)
    pyr = segment_pyramid(u, p, levels=0)
    assert pyr.level_iters == (int(direct.iters),)
    np.testing.assert_array_equal(np.asarray(pyr.mask),
                                  np.asarray(direct.mask))


def test_pyramid_vector_rgb():
    img, gt = colored_squares(128, 128, noise=5.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    pyr = segment_pyramid(u, p, min_dim=32,
                          lambda1=(1.0, 1.2, 0.8))
    assert pyr.c1.shape == (3,)
    assert len(pyr.level_iters) >= 2
    assert iou(np.asarray(pyr.mask), gt) >= 0.98


def test_pyramid_phi0_seeds_coarsest_level():
    """A user phi0 at full resolution must thread down to the coarsest
    level: seeding with the DIRECT run's converged phi must leave the
    coarsest level strictly less to do than the cold checkerboard/circle
    start (if phi0 were silently dropped the two would tie)."""
    img, _ = two_disks(128, 128, noise=5.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    direct = segment(u, p)
    cold = segment_pyramid(u, p, min_dim=32)
    seeded = segment_pyramid(u, p, min_dim=32, phi0=direct.phi)
    assert seeded.level_iters[0] < cold.level_iters[0]
    assert iou(np.asarray(seeded.mask), np.asarray(direct.mask)) >= 0.99


def test_plan_levels_sharded_clips_on_mesh_constraints():
    from chan_vese.models.pyramid import plan_levels_sharded

    # unconstrained: same as plan_levels
    assert plan_levels_sharded(512, 512, 1, 1, min_dim=32) == \
        plan_levels(512, 512, min_dim=32)
    # divisibility: 512 >> 4 = 32, 32 % 4 == 0 fine; nx=3 blocks all
    # levels whose dims aren't multiples of 3 (512 never is -> L=0...
    # but plan_levels_sharded only walks DOWN from the unsharded plan,
    # and level 0 = the input itself, whose divisibility segment_sharded
    # checks; the planner only guards the DECIMATED levels)
    assert plan_levels_sharded(512, 512, 4, 4, min_dim=32) >= 1
    # comm_k halo depth: coarsest shard must hold 4k-deep halos.
    # 256 with min_dim=32 -> L=3 unsharded (coarsest 32); on a 2x4 mesh
    # with comm_k=8 the coarsest shard must have min dim >= 32, so
    # 32x32 levels (shard 16x8) are clipped away
    L = plan_levels_sharded(256, 256, 2, 4, min_dim=32, comm_k=8)
    sh = (256 >> L) // 2, (256 >> L) // 4
    assert min(sh) >= 32
    # overlap rim: shards >= 16x16 at the coarsest level
    L = plan_levels_sharded(256, 256, 2, 4, min_dim=32, halo="overlap")
    assert min((256 >> L) // 2, (256 >> L) // 4) >= 16


def test_pyramid_sharded_matches_single_chip(grid_mesh):
    img, gt = two_disks(256, 256, noise=8.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    from chan_vese.models.pyramid import segment_pyramid_sharded

    single = segment_pyramid(u, p, min_dim=32)
    shard = segment_pyramid_sharded(u, p, grid_mesh, min_dim=32)
    assert len(shard.level_iters) >= 2
    assert iou(np.asarray(shard.mask), gt) >= 0.98
    assert iou(np.asarray(shard.mask), np.asarray(single.mask)) >= 0.99


def test_pyramid_sharded_comm_k(grid_mesh):
    img, gt = two_disks(256, 256, noise=8.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    from chan_vese.models.pyramid import segment_pyramid_sharded

    res = segment_pyramid_sharded(u, p, grid_mesh, min_dim=32, comm_k=4)
    assert iou(np.asarray(res.mask), gt) >= 0.98


def test_pyramid_sharded_cli_flag(tmp_path):
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    if jax.device_count() < 8:
        pytest.skip("needs 8 (fake) devices")
    img, gt = two_disks(256, 256, noise=5.0)
    src = tmp_path / "in.npy"
    np.save(src, img.astype(np.float32))
    out = tmp_path / "mask.png"
    rc = main([str(src), "-o", str(out), "--pyramid", "-1", "--mesh",
               "2", "4", "--f64", "--init", "circle", "--quiet"])
    assert rc == 0 and out.exists()
    mask = image_io.load_image(str(out)) > 127
    assert iou(mask, gt) >= 0.98


def test_pyramid_multiphase_matches_direct_labels():
    from chan_vese.models import multiphase as mp
    from test_multiphase import label_accuracy

    img, gt = four_regions(128, 128, noise=4.0)
    u = jnp.asarray(img, F64)
    p = CVParams(mu=0.003 * 255.0 ** 2, max_iter=300)
    direct = mp.segment_multiphase(u, p, m_sets=2)
    pyr = segment_pyramid_multiphase(u, p, min_dim=32)
    assert len(pyr.level_iters) >= 2
    assert label_accuracy(np.asarray(pyr.labels), gt) >= 0.97
    assert label_accuracy(np.asarray(pyr.labels),
                          np.asarray(direct.labels)) >= 0.97
    # NOTE: no work-saving assertion here - the default checkerboard
    # init puts zero contours everywhere, so the direct solve is already
    # ~size-independent (it converged in 10 iters at 128^2); the pyramid
    # pays when iterations scale with contour travel (circles, below)


def test_pyramid_multiphase_saves_work_circles_init():
    """With a localized (circles) init the direct solve's iterations
    scale with contour travel distance; the pyramid must cut the
    fine-equivalent total work - the reason the feature exists."""
    from chan_vese.models import multiphase as mp
    from chan_vese.models.multiphase import init_multiphase

    img, _ = four_regions(128, 128, noise=4.0)
    u = jnp.asarray(img, F64)
    p = CVParams(mu=0.003 * 255.0 ** 2, max_iter=500)
    phis0 = init_multiphase((128, 128), 2, kind="circles", dtype=F64)
    direct = mp.segment_multiphase(u, p, m_sets=2, phis0=phis0)
    pyr = segment_pyramid_multiphase(u, p, min_dim=32, phis0=phis0)
    assert int(pyr.iters) < int(direct.iters)
    total = sum(n * 0.25 ** lvl
                for lvl, n in enumerate(reversed(pyr.level_iters)))
    assert total < int(direct.iters)


def test_pyramid_multiphase_phis0_seeds_coarsest_level():
    from chan_vese.models import multiphase as mp

    img, _ = four_regions(128, 128, noise=4.0)
    u = jnp.asarray(img, F64)
    p = CVParams(mu=0.003 * 255.0 ** 2, max_iter=300)
    direct = mp.segment_multiphase(u, p, m_sets=2)
    cold = segment_pyramid_multiphase(u, p, min_dim=32)
    seeded = segment_pyramid_multiphase(u, p, min_dim=32,
                                        phis0=direct.phis)
    assert seeded.level_iters[0] < cold.level_iters[0]


def test_pyramid_multiphase_cli_flag(tmp_path):
    from chan_vese.cli import main
    from chan_vese.utils import image_io
    from test_multiphase import label_accuracy

    img, gt = four_regions(128, 128, noise=4.0)
    src = tmp_path / "in.npy"
    np.save(src, img.astype(np.float32))
    out = tmp_path / "labels.png"
    rc = main([str(src), "--multiphase", "2", "--pyramid", "-1",
               "--mu", "195", "--f64", "-o", str(out), "--quiet"])
    assert rc == 0 and out.exists()
    lab = image_io.load_image(str(out))
    # save_labels spreads {0..3} over [0,255]; undo the spread
    lab = np.rint(lab / 85.0).astype(np.int32)
    assert label_accuracy(lab, gt) >= 0.97


@pytest.mark.gpu
def test_pyramid_gpu_compiled_levels(gpu):
    """On the GPU every pyramid level is one compiled device program;
    the warm-started finest level must land in the direct solve's basin
    and save iterations."""
    from chan_vese.models.scalar import segment as segment_direct

    img, gt = two_disks(512, 512, noise=6.0, dtype=np.float32)
    u = jax.device_put(img.astype(np.float32), gpu)
    p = CVParams(init="circle")
    direct = segment_direct(u, p)
    pyr = segment_pyramid(u, p)   # default min_dim=128 -> 2 levels
    assert len(pyr.level_iters) >= 2
    assert iou(np.asarray(pyr.mask), gt) >= 0.97
    assert int(pyr.iters) < int(direct.iters)


def test_pyramid_cli_flag(tmp_path):
    """--pyramid -1 runs the coarse-to-fine path end-to-end; the flag is
    dropped (with a warning) in fixed mode."""
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    img, gt = two_disks(256, 256, noise=5.0)
    src = tmp_path / "in.npy"
    np.save(src, img.astype(np.float32))
    out = tmp_path / "mask.png"
    rc = main([str(src), "-o", str(out), "--pyramid", "-1", "--f64",
               "--init", "circle"])
    assert rc == 0 and out.exists()
    mask = image_io.load_image(str(out)) > 127
    assert iou(mask, gt) >= 0.98
    # fixed mode: flag warned away, still succeeds
    rc = main([str(src), "-o", str(out), "--pyramid", "2", "--iters", "40",
               "--init", "circle"])
    assert rc == 0


# --------------------------------------------------------------------------
# pyramid x morphological family
# --------------------------------------------------------------------------

def _disk512(seed=0):
    rng = np.random.default_rng(seed)
    H = W = 512
    yy, xx = np.mgrid[:H, :W]
    gt = (yy - 256) ** 2 + (xx - 256) ** 2 < 150 ** 2
    img = np.where(gt, 200.0, 0.0) + rng.normal(0, 5, (H, W))
    return jnp.asarray(img), gt


def test_pyramid_morph_matches_direct_and_saves_work():
    from chan_vese.models.morph import segment_morph
    from chan_vese.models.pyramid import segment_pyramid_morph

    u, gt = _disk512()
    p = CVParams(max_iter=500, tol=1e-5, patience=4, min_iter=4,
                 init="circle")
    res = segment_pyramid_morph(u, p, levels=2)
    assert iou(np.asarray(res.mask), gt) > 0.99
    direct = segment_morph(u, p)
    assert iou(np.asarray(direct.mask), gt) > 0.99
    # the finest level refines locally: it must need strictly fewer
    # iterations than the direct full-resolution run (measured 5 vs 36)
    assert int(res.iters) < int(direct.iters)
    assert len(res.level_iters) == 3


def test_pyramid_morph_ls0_seeds_coarsest():
    from chan_vese.models.pyramid import segment_pyramid_morph

    u, gt = _disk512()
    # seed with the ground truth: every level starts converged-ish, so
    # iteration counts collapse to the patience floor
    p = CVParams(max_iter=500, tol=1e-5, patience=3, min_iter=3)
    res = segment_pyramid_morph(u, p, levels=2,
                                ls0=jnp.asarray(gt.astype(np.float64)))
    assert iou(np.asarray(res.mask), gt) > 0.99
    assert int(res.iters) <= 8


def test_pyramid_gac_converges_from_small_seed():
    from chan_vese.models.pyramid import segment_pyramid_gac

    u, gt = _disk512()
    p = CVParams(max_iter=500, tol=1e-5, patience=4, min_iter=4,
                 init="small-disk")
    res = segment_pyramid_gac(u, p, levels=2, balloon=1, threshold=0.3,
                              gac_alpha=5.0, gac_sigma=2.0)
    assert iou(np.asarray(res.mask), gt) > 0.99
    # the balloon's contour travel happens at the COARSE level: the
    # finest level is local refinement only (measured 5 vs 27 coarse)
    assert int(res.iters) < res.level_iters[0]


def test_pyramid_morph_cli_flag(tmp_path):
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    u, gt = _disk512()
    src = tmp_path / "in.npy"
    np.save(src, np.asarray(u, np.float32))
    out = tmp_path / "m.png"
    rc = main([str(src), "--morph", "--pyramid", "2", "--init", "circle",
               "-o", str(out), "--f64", "--quiet"])
    assert rc == 0
    mask = image_io.load_image(str(out)) > 127
    assert iou(mask, gt) > 0.99

    outg = tmp_path / "g.png"
    rc = main([str(src), "--morph-gac", "--pyramid", "2", "--balloon",
               "1", "--init", "small-disk", "--gac-alpha", "5",
               "--gac-sigma", "2", "--gac-threshold", "0.3",
               "-o", str(outg), "--f64", "--quiet"])
    assert rc == 0
    mask = image_io.load_image(str(outg)) > 127
    assert iou(mask, gt) > 0.99


def test_pyramid_morph_mesh_drops_pyramid(tmp_path):
    """--morph --pyramid --mesh: pyramid dropped with a warning, the
    sharded path still runs (composition rule)."""
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    u, gt = _disk512()
    src = tmp_path / "in.npy"
    np.save(src, np.asarray(u, np.float32))
    out = tmp_path / "m.png"
    rc = main([str(src), "--morph", "--pyramid", "2", "--mesh", "2", "2",
               "--init", "circle", "-o", str(out), "--f64", "--quiet"])
    assert rc == 0
    mask = image_io.load_image(str(out)) > 127
    assert iou(mask, gt) > 0.99
