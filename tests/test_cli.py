"""End-to-end CLI tests (SURVEY.md C15 / L5) + trace & checkpoint utils."""

import numpy as np
import pytest

from chan_vese.cli import main
from chan_vese.utils import checkpoint, image_io, trace
from fixtures import colored_squares, iou, two_disks


@pytest.fixture()
def disk_png(tmp_path):
    img, gt = two_disks(64, 64, noise=6.0)
    p = tmp_path / "in.png"
    image_io._save_u8(p, np.clip(img, 0, 255).astype(np.uint8))
    return p, gt


def test_cli_grayscale_tol(disk_png, tmp_path):
    p, gt = disk_png
    out = tmp_path / "mask.png"
    ov = tmp_path / "ov.png"
    rc = main([str(p), "-o", str(out), "--overlay", str(ov),
               "--init", "circle", "--quiet"])
    assert rc == 0
    mask = image_io.load_image(out) > 127
    assert iou(mask, gt) >= 0.97
    assert ov.exists()


def test_cli_fixed_iters_with_trace(disk_png, tmp_path):
    p, gt = disk_png
    csv = tmp_path / "trace.csv"
    rc = main([str(p), "--iters", "40", "--init", "circle",
               "--trace-energy", str(csv), "--quiet",
               "-o", str(tmp_path / "m.png")])
    assert rc == 0
    tr = trace.read_energy_csv(csv)
    assert len(tr["energy"]) == 40
    assert (np.diff(tr["energy"]) <= 1e-6 * np.abs(tr["energy"][:-1])).all()


def test_cli_color(tmp_path):
    img, gt = colored_squares(64, 64, noise=4.0)
    p = tmp_path / "in.png"
    image_io._save_u8(p, np.clip(img, 0, 255).astype(np.uint8))
    out = tmp_path / "mask.png"
    rc = main([str(p), "--color", "-o", str(out), "--init", "circle",
               "--lambda1", "1", "1", "1", "--lambda2", "1", "1", "1",
               "--quiet"])
    assert rc == 0
    mask = image_io.load_image(out) > 127
    assert iou(mask, gt) >= 0.95


def test_cli_multiphase(tmp_path):
    from fixtures import four_regions

    img, gt = four_regions(64, 64, noise=4.0)
    p = tmp_path / "in.png"
    image_io._save_u8(p, np.clip(img, 0, 255).astype(np.uint8))
    out = tmp_path / "labels.png"
    rc = main([str(p), "--multiphase", "2", "--mu", "195",
               "-o", str(out), "--quiet"])
    assert rc == 0
    assert out.exists()
    lab = image_io.load_image(out)
    assert len(np.unique(lab)) >= 3  # several phases present


def test_cli_smoothing_and_f64(disk_png, tmp_path):
    p, gt = disk_png
    rc = main([str(p), "--smooth", "5", "--f64", "--init", "circle",
               "-o", str(tmp_path / "m.npy"), "--quiet"])
    assert rc == 0
    mask = np.load(tmp_path / "m.npy") > 127
    assert iou(mask, gt) >= 0.95


def test_cli_evolution_gif(disk_png, tmp_path):
    p, _ = disk_png
    gif = tmp_path / "evo.gif"
    rc = main([str(p), "--iters", "20", "--init", "circle",
               "--evolution-gif", str(gif), "--quiet"])
    assert rc == 0
    assert gif.stat().st_size > 0


def test_cli_mesh_sharded(tmp_path):
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 fake devices")
    img, gt = two_disks(64, 64, noise=6.0)
    p = tmp_path / "in.png"
    image_io._save_u8(p, np.clip(img, 0, 255).astype(np.uint8))
    out = tmp_path / "mask.png"
    rc = main([str(p), "--mesh", "2", "4", "--init", "circle",
               "-o", str(out), "--quiet"])
    assert rc == 0
    mask = image_io.load_image(out) > 127
    assert iou(mask, gt) >= 0.97


def test_trace_parity_tool(tmp_path):
    e = np.linspace(10, 1, 30)
    trace.write_energy_csv(tmp_path / "a.csv", e, delta=e * 0.1)
    trace.write_energy_csv(tmp_path / "b.csv", e * (1 + 5e-6))
    assert trace.trace_parity(tmp_path / "a.csv", tmp_path / "b.csv") < 1e-5
    trace.write_energy_csv(tmp_path / "c.csv", e * 1.01)
    assert trace.trace_parity(tmp_path / "a.csv", tmp_path / "c.csv") > 1e-3


def test_checkpoint_roundtrip_and_resume(tmp_path):
    import jax.numpy as jnp

    from chan_vese import CVParams, segment_fixed

    img, _ = two_disks(32, 32, noise=4.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(init="circle")
    ck = tmp_path / "ck"
    phi_a = checkpoint.segment_with_checkpoints(u, p, iters=20,
                                                ckpt_dir=ck, every=5)
    assert checkpoint.latest(ck).name == "ckpt_00000020.npz"
    # fresh run, no checkpoints
    ref = segment_fixed(u, p, iters=20).phi
    np.testing.assert_allclose(np.asarray(phi_a), np.asarray(ref),
                               rtol=1e-10, atol=1e-10)
    # resume: extend to 30 iters, must match a straight 30-iter run
    phi_b = checkpoint.segment_with_checkpoints(u, p, iters=30,
                                                ckpt_dir=ck, every=5)
    ref30 = segment_fixed(u, p, iters=30).phi
    np.testing.assert_allclose(np.asarray(phi_b), np.asarray(ref30),
                               rtol=1e-10, atol=1e-10)


def test_cli_diverged_exit_code(tmp_path):
    """ADVICE.md round-1: a diverged run must return rc=1 and write no
    output artifacts (scripted callers used to see a silent success)."""
    bad = np.full((64, 64), np.nan, np.float32)
    inp = tmp_path / "bad.npy"
    np.save(inp, bad)
    out = tmp_path / "mask.png"
    rc = main([str(inp), "-o", str(out), "--quiet"])
    assert rc == 1
    assert not out.exists()


def test_cli_rect_init_with_mesh(tmp_path):
    """ADVICE.md round-1: --init rect + --mesh used to crash inside the
    shard_map trace; the sharded init now mirrors utils/init_phi.rect."""
    import jax

    if jax.device_count() < 4:
        pytest.skip("needs 4 fake devices")
    img, gt = two_disks(64, 64, noise=6.0)
    inp = tmp_path / "in.png"
    image_io._save_u8(inp, np.clip(img, 0, 255).astype(np.uint8))
    out = tmp_path / "mask.png"
    rc = main([str(inp), "-o", str(out), "--init", "rect",
               "--mesh", "2", "2", "--quiet"])
    assert rc == 0
    mask = image_io.load_image(out) > 127
    assert iou(mask, gt) >= 0.95


def test_sharded_rect_matches_unsharded(tmp_path):
    import jax
    import jax.numpy as jnp

    if jax.device_count() < 4:
        pytest.skip("needs 4 fake devices")
    from chan_vese import CVParams, segment_fixed
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    from chan_vese.parallel.sharded import _make_phi0
    from chan_vese.utils.init_phi import init_phi

    mesh = make_grid_mesh(2, 2)
    # the sharded rect init is exactly the unsharded one
    np.testing.assert_array_equal(
        np.asarray(_make_phi0((64, 64), "rect", jnp.float64, mesh)),
        np.asarray(init_phi((64, 64), "rect", jnp.float64)))

    img, _ = two_disks(64, 64, noise=6.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(init="rect")
    res = segment_sharded(u, p, mesh, max_iter=10, fixed=True)
    ref = segment_fixed(u, p, iters=10)
    # trajectories drift at reduction-order level (psum'd c1/c2); masks
    # and phi agree loosely
    assert iou(np.asarray(res.mask), np.asarray(ref.mask)) >= 0.999
    np.testing.assert_allclose(np.asarray(res.phi), np.asarray(ref.phi),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cli_tolerance_gpu(gpu, tmp_path):
    """On the GPU the tolerance-mode grayscale CLI segments correctly
    end-to-end (f32, compiled by XLA for the card)."""
    img, gt = two_disks(512, 512, noise=6.0)
    pth = tmp_path / "in.png"
    image_io._save_u8(pth, np.clip(img, 0, 255).astype(np.uint8))
    out = tmp_path / "m.png"
    rc = main([str(pth), "--init", "circle", "--quiet", "-o", str(out)])
    assert rc == 0
    mask = image_io.load_image(out) > 127
    assert iou(mask, gt) >= 0.97
