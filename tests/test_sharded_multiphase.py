"""Multiphase over the 2D mesh (SURVEY.md C10 x spatial sharding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.ops import sweep_np
from chan_vese.params import CVParams
from chan_vese.parallel import mesh as meshmod
from chan_vese.parallel.sharded import segment_multiphase_sharded
from fixtures import four_regions

F32 = jnp.float32


@pytest.fixture(scope="module")
def grid_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (fake) devices")
    return meshmod.make_grid_mesh(2, 4)


def test_sharded_multiphase_matches_unsharded(grid_mesh):
    from chan_vese.models.multiphase import segment_multiphase_fixed

    img, gt = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, F32)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=20, fixed=True)
    ref = segment_multiphase_fixed(u, p, iters=20, m_sets=2)
    lab_diff = (np.asarray(res.labels) != np.asarray(ref.labels)).sum()
    assert lab_diff <= 5, lab_diff


def test_sharded_multiphase_f64_exactness(grid_mesh):
    from chan_vese.models.multiphase import segment_multiphase_fixed

    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=3, fixed=True)
    ref = segment_multiphase_fixed(u, p, iters=3, m_sets=2)
    np.testing.assert_allclose(np.asarray(res.phis), np.asarray(ref.phis),
                               rtol=1e-10, atol=1e-8)


def test_sharded_multiphase_rgb(grid_mesh):
    """Vector-valued multiphase over the mesh (the last cell of the
    model-family x parallelism matrix)."""
    from chan_vese.models.multiphase import segment_multiphase_fixed

    rng = np.random.default_rng(0)
    colors = np.array([[220.0, 40.0, 40.0], [40.0, 220.0, 40.0],
                       [40.0, 40.0, 220.0], [200.0, 200.0, 200.0]])
    lab = np.zeros((64, 64), np.int32)
    lab[:32, 32:] = 1
    lab[32:, :32] = 2
    lab[32:, 32:] = 3
    img = colors[lab] + 3.0 * rng.standard_normal((64, 64, 3))
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=5, fixed=True)
    ref = segment_multiphase_fixed(u, p, iters=5, m_sets=2)
    np.testing.assert_allclose(np.asarray(res.phis), np.asarray(ref.phis),
                               rtol=1e-10, atol=1e-8)


def test_sharded_multiphase_tol_converges(grid_mesh):
    import itertools

    img, gt = four_regions(64, 64, noise=4.0)
    p = CVParams(mu=0.003 * 255 ** 2, max_iter=200)
    res = segment_multiphase_sharded(jnp.asarray(img, F32), p, grid_mesh,
                                     m_sets=2)
    assert int(res.iters) < 200
    pred = np.asarray(res.labels)
    best = max(float((np.asarray(perm)[pred] == gt).mean())
               for perm in itertools.permutations(range(4)))
    assert best >= 0.97, best


def _phis0(shape, m_sets=2):
    from chan_vese.models.multiphase import init_multiphase
    return np.asarray(init_multiphase(shape, m_sets, dtype=jnp.float64))


def test_sharded_multiphase_wide_matches_numpy(grid_mesh):
    """64x256 over the 2x4 mesh vs the unsharded numpy trajectory; rtol
    1e-7: the means differ at f64 summation-order level (psum of shard
    partials vs whole-image sums) and the Dirac nonlinearity amplifies
    that over 8 iterations (measured ~1.3e-8 worst case)."""
    img, _ = four_regions(64, 256, noise=4.0)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(jnp.asarray(img), p, grid_mesh,
                                     m_sets=2, max_iter=8, fixed=True)
    want = sweep_np.segment_multiphase(img, p, 8, _phis0((64, 256)))
    np.testing.assert_allclose(np.asarray(res.phis), want, rtol=1e-7,
                               atol=1e-7)


def test_sharded_multiphase_f32_matches_numpy_labels(grid_mesh):
    """f32 on the mesh lands on the f64 numpy labels after 20 iterations
    (a handful of contour pixels may differ)."""
    img, _ = four_regions(64, 64, noise=4.0)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(jnp.asarray(img, F32), p, grid_mesh,
                                     m_sets=2, max_iter=20, fixed=True)
    want = sweep_np.segment_multiphase(img, p, 20, _phis0((64, 64)))
    lab = sum((want[m] >= 0).astype(np.int32) << m for m in range(2))
    lab_diff = (np.asarray(res.labels) != lab).sum()
    assert lab_diff <= 5, lab_diff


def test_sharded_multiphase_trace_matches_unsharded(grid_mesh):
    """psum'd sharded multiphase energy/flip trace == the unsharded
    fixed-trace run at 1e-9 f64 (VERDICT r2 item 5 'Done' criterion)."""
    from chan_vese.models.multiphase import segment_multiphase_fixed
    from chan_vese.parallel.sharded import (
        segment_multiphase_sharded_fixed_trace)

    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    tr = segment_multiphase_sharded_fixed_trace(u, p, grid_mesh, iters=6,
                                                m_sets=2)
    ref = segment_multiphase_fixed(u, p, iters=6, m_sets=2)
    np.testing.assert_allclose(np.asarray(tr.energy),
                               np.asarray(ref.energy),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(tr.delta), np.asarray(ref.delta),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(tr.labels),
                                  np.asarray(ref.labels))


def test_sharded_multiphase_trace_energy_monotone(grid_mesh):
    from chan_vese.parallel.sharded import (
        segment_multiphase_sharded_fixed_trace)

    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, F32)
    p = CVParams(mu=0.003 * 255 ** 2)
    tr = segment_multiphase_sharded_fixed_trace(u, p, grid_mesh, iters=12,
                                                m_sets=2)
    e = np.asarray(tr.energy)
    assert np.all(np.diff(e) <= np.abs(e[:-1]) * 1e-5)


def test_sharded_multiphase_checkpoint_roundtrip(grid_mesh, tmp_path):
    """Chunked checkpointed run == straight run; resume picks up the
    newest checkpoint."""
    from chan_vese.utils.checkpoint_sharded import (
        latest_sharded, segment_multiphase_sharded_with_checkpoints)

    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded_with_checkpoints(
        u, p, grid_mesh, iters=6, ckpt_dir=tmp_path, every=3)
    ref = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=6, fixed=True)
    np.testing.assert_allclose(np.asarray(res.phis), np.asarray(ref.phis),
                               rtol=1e-10, atol=1e-10)
    ck = latest_sharded(tmp_path)
    assert ck is not None and ck.name == "ckpt_00000006"
    # resume: a re-run with a higher target starts from iteration 6
    res2 = segment_multiphase_sharded_with_checkpoints(
        u, p, grid_mesh, iters=9, ckpt_dir=tmp_path, every=3)
    ref2 = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                      max_iter=9, fixed=True)
    np.testing.assert_allclose(np.asarray(res2.phis),
                               np.asarray(ref2.phis),
                               rtol=1e-10, atol=1e-10)


def test_sharded_multiphase_m1_matches_numpy(grid_mesh):
    """M = 1 (two phases through the coupling term) on the mesh == the
    numpy multiphase trajectory."""
    img, _ = four_regions(64, 64, noise=4.0)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(jnp.asarray(img), p, grid_mesh,
                                     m_sets=1, max_iter=5, fixed=True)
    want = sweep_np.segment_multiphase(img, p, 5, _phis0((64, 64), 1))
    np.testing.assert_allclose(np.asarray(res.phis), want, rtol=1e-9,
                               atol=1e-9)


def test_cli_multiphase_sharded_surfaces(grid_mesh, tmp_path):
    """CLI: sharded multiphase with trace, checkpoint and gif (the
    warn-drops of VERDICT r2 missing #4 lifted)."""
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    img, _ = four_regions(64, 64, noise=4.0)
    pth = tmp_path / "in.png"
    image_io._save_u8(pth, np.clip(img, 0, 255).astype(np.uint8))
    out = tmp_path / "lab.png"
    csv = tmp_path / "trace.csv"
    rc = main([str(pth), "--mesh", "2", "4", "--multiphase", "2",
               "--mu", "195", "--iters", "8", "--quiet",
               "--trace-energy", str(csv), "-o", str(out)])
    assert rc == 0 and out.exists() and csv.exists()
    assert len(csv.read_text().strip().splitlines()) == 9  # header + 8

    ck = tmp_path / "ck"
    gif = tmp_path / "ev.gif"
    rc = main([str(pth), "--mesh", "2", "4", "--multiphase", "2",
               "--mu", "195", "--iters", "6", "--quiet",
               "--checkpoint-dir", str(ck), "--checkpoint-every", "3",
               "--evolution-gif", str(gif), "--gif-every", "3",
               "-o", str(out)])
    assert rc == 0 and gif.exists()
    assert (ck / "ckpt_00000006").is_dir()


@pytest.mark.parametrize("k,iters", [(2, 6), (2, 7)])
def test_multiphase_commk_matches_frozen_cs_reference(grid_mesh, k, iters):
    """Multiphase comm_k chunks: one 8k-deep exchange per k coupled
    iterations, frozen phase means - 1e-9 f64 vs the unsharded numpy
    frozen-cs reference."""
    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=iters, fixed=True,
                                     comm_k=k)
    want = sweep_np.segment_multiphase(img, p, iters, _phis0((64, 64)), k)
    np.testing.assert_allclose(np.asarray(res.phis), np.asarray(want),
                               rtol=1e-9, atol=1e-9)


def test_multiphase_commk_rgb(grid_mesh):
    """Vector-valued multiphase comm_k chunks vs the frozen-cs
    reference (per-channel means)."""
    rng = np.random.default_rng(0)
    colors = np.array([[220.0, 40.0, 40.0], [40.0, 220.0, 40.0],
                       [40.0, 40.0, 220.0], [200.0, 200.0, 200.0]])
    lab = np.zeros((64, 64), np.int32)
    lab[:32, 32:] = 1
    lab[32:, :32] = 2
    lab[32:, 32:] = 3
    img = colors[lab] + 3.0 * rng.standard_normal((64, 64, 3))
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=6, fixed=True, comm_k=2)
    want = sweep_np.segment_multiphase(img, p, 6, _phis0((64, 64)), 2)
    np.testing.assert_allclose(np.asarray(res.phis), np.asarray(want),
                               rtol=1e-9, atol=1e-9)


def test_multiphase_commk_wide_matches_numpy_chunks(grid_mesh):
    """comm_k on 64x256 (32x64 shards) == the unsharded numpy loop with
    the phase means frozen per chunk."""
    img, _ = four_regions(64, 256, noise=4.0)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(jnp.asarray(img), p, grid_mesh,
                                     m_sets=2, max_iter=6, fixed=True,
                                     comm_k=2)
    want = sweep_np.segment_multiphase(img, p, 6, _phis0((64, 256)), 2)
    np.testing.assert_allclose(np.asarray(res.phis), want, rtol=1e-8,
                               atol=1e-8)


def test_multiphase_commk_tolerance_and_validation(grid_mesh):
    import itertools

    img, gt = four_regions(64, 64, noise=4.0)
    p = CVParams(mu=0.003 * 255 ** 2, max_iter=200)
    res = segment_multiphase_sharded(jnp.asarray(img, F32), p, grid_mesh,
                                     m_sets=2, comm_k=2)
    assert int(res.iters) < 200
    pred = np.asarray(res.labels)
    best = max(float((np.asarray(perm)[pred] == gt).mean())
               for perm in itertools.permutations(range(4)))
    assert best >= 0.97, best

    with pytest.raises(ValueError, match="comm_k"):
        segment_multiphase_sharded(jnp.asarray(img, F32), p, grid_mesh,
                                   comm_k=0)
    with pytest.raises(ValueError, match="8\\*comm_k"):
        segment_multiphase_sharded(jnp.asarray(img, F32), p, grid_mesh,
                                   comm_k=8)  # 64 > 32x16 shards


def test_sharded_multiphase_overlap_matches_standard(grid_mesh):
    """halo='overlap' (interior from owned data while the M exchanges
    fly, rim stitched from the exchanged pads) is elementwise the
    exchange-then-sweep path."""
    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    ref = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=3, fixed=True)
    got = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=3, fixed=True,
                                     halo="overlap")
    assert np.array_equal(np.asarray(got.phis), np.asarray(ref.phis))


def test_sharded_multiphase_overlap_rgb(grid_mesh):
    """Vector-valued multiphase overlap (channel-averaged coupling term
    shares the same interior/rim split)."""
    rng = np.random.default_rng(3)
    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(np.stack([img + rng.normal(0, 2, img.shape)
                              for _ in range(3)], axis=-1), jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    ref = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=3, fixed=True)
    got = segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                     max_iter=3, fixed=True,
                                     halo="overlap")
    assert np.array_equal(np.asarray(got.phis), np.asarray(ref.phis))


def test_sharded_multiphase_overlap_guards(grid_mesh):
    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, F32)
    p = CVParams()
    with pytest.raises(ValueError, match="overlap x comm_k"):
        segment_multiphase_sharded(u, p, grid_mesh, m_sets=2,
                                   comm_k=2, halo="overlap")
    with pytest.raises(ValueError, match="halo='overlap'"):
        segment_multiphase_sharded(u[:16], p, grid_mesh, max_iter=1,
                                   halo="overlap")  # 8x16 shards


def test_sharded_multiphase_m3_f64_exactness(grid_mesh):
    """General-M claim pinned UNDER SHARDING (VERDICT r3 weak #7: every
    sharded multiphase test used m_sets=2): M=3 (8 phases) jnp path on
    the fake mesh must match the unsharded driver to f64 tightness.

    Measured agreement: ~1e-14 after 1 iteration (the psum reduction
    tree differs from the unsharded global sum, so bitwise equality is
    not expected), amplified to ~6e-10 by iteration 4 through the
    H_eps/mean feedback - same tolerance convention as the M=2
    exactness test above."""
    from chan_vese.models.multiphase import segment_multiphase_fixed

    img, _ = four_regions(64, 64, noise=4.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(mu=0.003 * 255 ** 2)
    res = segment_multiphase_sharded(u, p, grid_mesh, m_sets=3,
                                     max_iter=4, fixed=True)
    ref = segment_multiphase_fixed(u, p, iters=4, m_sets=3)
    assert res.phis.shape == (3,) + u.shape
    np.testing.assert_allclose(np.asarray(res.phis), np.asarray(ref.phis),
                               rtol=1e-10, atol=1e-8)
    lab_diff = (np.asarray(res.labels) != np.asarray(ref.labels)).sum()
    assert lab_diff == 0, lab_diff
