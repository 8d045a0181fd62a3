"""Morphological Chan-Vese (MorphACWE) family tests.

Golden = an independent numpy transcription of the published scheme
(Marquez-Neila et al., PAMI 2014; chan_vese/ops/morph_np.py) with the
framework's replica/Neumann edge convention (ops/morph.py docstring).
The binary state makes jnp-vs-numpy equivalence EXACT in f64 for seeded
random inputs (the only approximation risk is a data force within one
reduction-order ulp of zero, measure-zero for continuous random images).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.compat import (checkerboard_level_set, disk_level_set,
                              morphological_chan_vese)
from chan_vese.models.morph import (segment_morph, segment_morph_fixed)
from chan_vese.ops.morph_np import morph_acwe as np_morph_acwe
from chan_vese.params import CVParams

from fixtures import two_disks, iou


# --------------------------------------------------------------------------
# equivalence vs the golden (exact, f64)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0, 1, 2])
def test_matches_numpy_golden_gray(smoothing):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 56))
    ls0 = (rng.uniform(size=(40, 56)) > 0.5).astype(np.float64)
    want = np_morph_acwe(img, ls0, iters=12, smoothing=smoothing)
    got = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=12,
                              ls0=jnp.asarray(ls0), smoothing=smoothing)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_matches_numpy_golden_rgb_weighted():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (32, 48, 3))
    ls0 = (rng.uniform(size=(32, 48)) > 0.5).astype(np.float64)
    l1, l2 = (1.0, 0.5, 2.0), (2.0, 1.0, 0.25)
    want = np_morph_acwe(img, ls0, iters=10, smoothing=1,
                         l1=np.array(l1), l2=np.array(l2))
    got = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=10,
                              ls0=jnp.asarray(ls0), smoothing=1,
                              lambda1=l1, lambda2=l2)
    np.testing.assert_array_equal(np.asarray(got.ls), want)


def test_operator_alternation_matters():
    """SIoIS and ISoSI differ on asymmetric structures; the alternation
    counter must advance per smoothing call (start_iter plumbs it)."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (24, 24))
    ls0 = (rng.uniform(size=(24, 24)) > 0.5).astype(np.float64)
    a = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=1,
                            ls0=jnp.asarray(ls0), smoothing=1,
                            start_iter=0)
    b = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=1,
                            ls0=jnp.asarray(ls0), smoothing=1,
                            start_iter=1)
    assert (np.asarray(a.ls) != np.asarray(b.ls)).any()
    # chunked run (2x1 iter with the offset) == one 2-iter run
    mid = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=1,
                              ls0=jnp.asarray(ls0), smoothing=1)
    two = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=1,
                              ls0=mid.ls, smoothing=1, start_iter=1)
    whole = segment_morph_fixed(jnp.asarray(img), CVParams(), iters=2,
                                ls0=jnp.asarray(ls0), smoothing=1)
    np.testing.assert_array_equal(np.asarray(two.ls), np.asarray(whole.ls))


# --------------------------------------------------------------------------
# segmentation quality + driver behavior
# --------------------------------------------------------------------------

def _iou_sym(mask, gt):
    """ACWE labels are symmetric under checkerboard init."""
    return max(iou(mask, gt), iou(~mask, gt))


def test_converges_on_disks_gray():
    """The tolerance mode must terminate well under the cap even though a
    couple of boundary pixels flip forever (the period-2 limit cycle of
    the alternating smoothing, detected via the two-iterations-back
    comparison - see segment_morph's docstring)."""
    img, gt = two_disks(96, 96, noise=8.0)
    res = segment_morph(jnp.asarray(img), CVParams(max_iter=200))
    assert _iou_sym(np.asarray(res.mask), gt) >= 0.98
    assert int(res.iters) < 30      # 2-cycle detection actually fired
    assert float(res.delta) == 0.0


def test_converges_rgb():
    img, gt = two_disks(96, 96, noise=8.0)
    imgc = np.stack([img, 0.5 * img + 30.0, 255.0 - img], axis=-1)
    res = segment_morph(jnp.asarray(imgc), CVParams(max_iter=200))
    assert _iou_sym(np.asarray(res.mask), gt) >= 0.98
    # inside/outside means are per-channel vectors
    assert np.asarray(res.c1).shape == (3,)


def test_smoothing_reduces_boundary_roughness():
    img, gt = two_disks(96, 96, noise=12.0)

    def rough(m):
        return int((m[1:, :] != m[:-1, :]).sum()
                   + (m[:, 1:] != m[:, :-1]).sum())

    r0 = segment_morph(jnp.asarray(img), CVParams(max_iter=200),
                       smoothing=0)
    r3 = segment_morph(jnp.asarray(img), CVParams(max_iter=200),
                       smoothing=3)
    assert rough(np.asarray(r3.mask)) < rough(np.asarray(r0.mask))


def test_constant_image_is_finite():
    """Empty-region guard: a constant image never divides by zero and the
    driver converges (to a frozen state) instead of NaN-aborting."""
    img = jnp.full((32, 32), 127.0)
    res = segment_morph(img, CVParams(max_iter=50))
    assert np.isfinite(np.asarray(res.c1)).all()
    assert np.isfinite(float(res.delta))


def test_nan_image_aborts():
    """Divergence detection: a NaN image poisons the flip metric and the
    loop aborts early instead of burning max_iter (SURVEY.md §5)."""
    img = np.full((32, 32), 100.0)
    img[3, 3] = np.nan
    res = segment_morph(jnp.asarray(img), CVParams(max_iter=500))
    assert int(res.iters) < 500
    assert not np.isfinite(float(res.delta))


# --------------------------------------------------------------------------
# compat surface
# --------------------------------------------------------------------------

def test_compat_level_set_helpers():
    cb = checkerboard_level_set((10, 12), square_size=5)
    assert cb.dtype == np.int8 and cb.shape == (10, 12)
    assert cb[0, 0] == 0 and cb[0, 5] == 1 and cb[5, 5] == 0
    d = disk_level_set((64, 64))
    assert d.dtype == np.int8
    # default radius 3/8*64 = 24: center inside, frame outside
    assert d[32, 32] == 1 and d[0, 0] == 0
    assert abs(d.sum() - np.pi * 24 ** 2) / (np.pi * 24 ** 2) < 0.02


def test_compat_runs_exactly_num_iter_and_matches_golden():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (30, 35))
    want = np_morph_acwe(img, checkerboard_level_set(img.shape),
                         iters=9, smoothing=2)
    got = morphological_chan_vese(img.astype(np.float64), num_iter=9,
                                  smoothing=2)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want.astype(np.int8))


def test_compat_iter_callback_chunks_match_fast_path():
    img, _ = two_disks(48, 48, noise=5.0)
    states = []
    got = morphological_chan_vese(img, num_iter=7,
                                  iter_callback=states.append)
    assert len(states) == 8          # init + one per iteration
    np.testing.assert_array_equal(states[-1], got)
    fast = morphological_chan_vese(img, num_iter=7)
    np.testing.assert_array_equal(got, fast)


def test_compat_custom_init_array_and_errors():
    img, gt = two_disks(64, 64, noise=4.0)
    ls = morphological_chan_vese(img, num_iter=60,
                                 init_level_set=disk_level_set(img.shape))
    assert iou(ls > 0, gt) >= 0.98   # object-seeded init pins the labels
    with pytest.raises(ValueError):
        morphological_chan_vese(img, 5, init_level_set=np.zeros((3, 3)))
    with pytest.raises(ValueError):
        morphological_chan_vese(img, 5, init_level_set="blob")


# --------------------------------------------------------------------------
# on the GPU (marked gpu; skipped without one)
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_morph_gpu_matches_cpu_masks(gpu):
    """Compiled f32 on the GPU converges to the same mask as the f64
    golden on a clean synthetic (binary state: only force-sign ties could
    differ, and the synthetic has none)."""
    img, gt = two_disks(256, 256, noise=6.0, dtype=np.float32)
    ls0 = checkerboard_level_set(img.shape).astype(np.float32)
    res = segment_morph(jax.device_put(img, gpu), CVParams(max_iter=300),
                        ls0=jax.device_put(ls0, gpu))
    m = np.asarray(res.mask)
    assert _iou_sym(m, gt) >= 0.99
    want = np_morph_acwe(img, ls0, iters=int(res.iters), smoothing=1)
    # f32-vs-f64 force-sign ties could flip isolated contour pixels
    assert (m == (want > 0.5)).mean() >= 0.999


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_morph(tmp_path):
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    img, gt = two_disks(96, 96, noise=6.0)
    src = tmp_path / "in.npy"
    np.save(src, img.astype(np.float32))
    out = tmp_path / "mask.png"

    # tolerance mode
    rc = main([str(src), "--morph", "-o", str(out), "--f64", "--quiet"])
    assert rc == 0 and out.exists()
    mask = image_io.load_image(str(out)) > 127
    assert _iou_sym(mask, gt) >= 0.97

    # fixed mode with energy trace + evolution gif
    csv = tmp_path / "trace.csv"
    gif = tmp_path / "evo.gif"
    rc = main([str(src), "--morph", "--iters", "20", "-o", str(out),
               "--trace-energy", str(csv), "--evolution-gif", str(gif),
               "--gif-every", "7", "--f64", "--quiet"])
    assert rc == 0 and csv.exists() and gif.exists()

    # color route with per-channel lambdas
    imgc = np.stack([img, 0.5 * img + 30.0, 255.0 - img], axis=-1)
    srcc = tmp_path / "in_rgb.npy"
    np.save(srcc, imgc.astype(np.float32))
    rc = main([str(srcc), "--morph", "--color", "--lambda1", "1", "1", "1",
               "-o", str(out), "--f64", "--quiet"])
    assert rc == 0
    mask = image_io.load_image(str(out)) > 127
    assert _iou_sym(mask, gt) >= 0.97

    # --morph + --multiphase: morph dropped with a warning, still succeeds
    rc = main([str(src), "--morph", "--multiphase", "2", "-o", str(out),
               "--f64", "--quiet"])
    assert rc == 0


# --------------------------------------------------------------------------
# sharded (GSPMD over the fake 8-device mesh)
# --------------------------------------------------------------------------

def test_sharded_matches_unsharded_exact():
    """segment_morph_sharded == segment_morph exactly on the binary state
    (2x4 mesh; only a force-sign tie within one reduction-order ulp could
    differ, absent on the seeded image), with the result still sharded
    over every device."""
    from chan_vese.models.morph import segment_morph_sharded
    from chan_vese.parallel.mesh import make_grid_mesh

    img, gt = two_disks(96, 96, noise=8.0)
    mesh = make_grid_mesh(2, 4)
    want = segment_morph(jnp.asarray(img), CVParams(max_iter=200))
    got = segment_morph_sharded(jnp.asarray(img), CVParams(max_iter=200),
                                mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got.ls), np.asarray(want.ls))
    assert int(got.iters) == int(want.iters)
    assert len(got.ls.sharding.device_set) == 8

    imgc = np.stack([img, 0.5 * img + 30.0, 255.0 - img], axis=-1)
    wc = segment_morph(jnp.asarray(imgc), CVParams(max_iter=200))
    gc = segment_morph_sharded(jnp.asarray(imgc), CVParams(max_iter=200),
                               mesh=mesh)
    np.testing.assert_array_equal(np.asarray(gc.ls), np.asarray(wc.ls))

    with pytest.raises(ValueError):
        segment_morph_sharded(jnp.asarray(img[:95]), CVParams(), mesh=mesh)
    with pytest.raises(ValueError):
        segment_morph_sharded(jnp.asarray(img), CVParams())


def test_cli_morph_mesh(tmp_path):
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    img, gt = two_disks(96, 96, noise=6.0)
    src = tmp_path / "in.npy"
    np.save(src, img.astype(np.float32))
    out = tmp_path / "mask.png"
    rc = main([str(src), "--morph", "--mesh", "2", "4", "-o", str(out),
               "--f64", "--quiet"])
    assert rc == 0
    mask = image_io.load_image(str(out)) > 127
    assert _iou_sym(mask, gt) >= 0.97
    # fixed mode on the mesh (trace written from the sharded run)
    csv = tmp_path / "t.csv"
    rc = main([str(src), "--morph", "--mesh", "2", "4", "--iters", "15",
               "--trace-energy", str(csv), "-o", str(out), "--f64",
               "--quiet"])
    assert rc == 0 and csv.exists()


def test_lean_iterations_driver_matches_traced():
    """segment_morph_iterations (the bench/raw-throughput path) runs the
    exact trajectory of segment_morph_fixed, including the alternation
    offset."""
    from chan_vese.models.morph import segment_morph_iterations

    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 255, (48, 64)))
    a = segment_morph_iterations(img, CVParams(), iters=11, start_iter=3)
    b = segment_morph_fixed(img, CVParams(), iters=11, start_iter=3)
    np.testing.assert_array_equal(np.asarray(a.ls), np.asarray(b.ls))
