"""Regression tests for the full-branch code-review findings."""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.params import CVParams
from fixtures import iou, two_disks

F64 = jnp.float64
F32 = jnp.float32


def test_gray_lambdas_respected():
    """Finding 1: scalar lambda overrides on grayscale inputs are honored
    (equal to folding them into the params) and per-channel tuples on a
    grayscale image are rejected."""
    from chan_vese import chan_vese, segment

    img, _ = two_disks(64, 128, noise=6.0)
    u = jnp.asarray(img, F32)
    p = CVParams(init="circle")
    a = segment(u, p, lambda1=2.0, lambda2=0.5)
    b = segment(u, p)
    assert int(a.iters) != int(b.iters) or \
        not np.array_equal(np.asarray(a.phi), np.asarray(b.phi))
    c = segment(u, p.replace(lambda1=2.0, lambda2=0.5))
    np.testing.assert_allclose(np.asarray(a.phi), np.asarray(c.phi),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        chan_vese(img, lambda1=(1.0, 2.0, 3.0))


def test_reinit_respected():
    """Finding 2: the fixed-iteration driver applies reinit_every."""
    from chan_vese import segment_fixed

    img, gt = two_disks(64, 128, noise=6.0)
    u = jnp.asarray(img, F32)
    p = CVParams(init="circle", reinit_every=5, reinit_steps=20)
    tr_r = segment_fixed(u, p, iters=30)
    tr_n = segment_fixed(u, p.replace(reinit_every=0), iters=30)
    phi_r = tr_r.phi
    # reinit bounds |phi| near the contour; without it phi drifts large
    assert not np.allclose(np.asarray(phi_r), np.asarray(tr_n.phi))
    from chan_vese.ops.numerics import grad_central
    gx, gy = grad_central(phi_r)
    band = np.abs(np.asarray(phi_r)) < 3.0
    g = np.asarray(jnp.sqrt(gx ** 2 + gy ** 2))
    assert 0.4 < np.median(g[band]) < 2.0
    assert iou(np.asarray(tr_r.mask), gt) >= 0.98


def test_batched_reinit_matches_single_frame():
    """With reinit on, every frame of the stack driver follows the
    single-image trajectory (the cadence counter is shared)."""
    from chan_vese import segment_fixed, segment_stack_fixed

    img, _ = two_disks(64, 128, noise=6.0)
    u = jnp.asarray(img, F32)
    p = CVParams(init="circle", reinit_every=4, reinit_steps=10)
    phis, _ = segment_stack_fixed(jnp.stack([u, u[::-1]]), p, iters=12)
    for k, frame in enumerate((u, u[::-1])):
        tr = segment_fixed(frame, p, iters=12)
        np.testing.assert_allclose(np.asarray(phis[k]), np.asarray(tr.phi),
                                   rtol=1e-5, atol=1e-4)


def test_sharded_gray_lambdas_respected():
    """Review 2 finding 1: segment_sharded must honor scalar lambda
    overrides on grayscale inputs."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 fake devices")
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    mesh = make_grid_mesh(2, 4)
    img, _ = two_disks(64, 64, noise=6.0)
    u = jnp.asarray(img, F32)
    p = CVParams(init="circle")
    a = segment_sharded(u, p, mesh, max_iter=8, fixed=True,
                        lambda1=5.0, lambda2=0.2)
    b = segment_sharded(u, p, mesh, max_iter=8, fixed=True)
    c = segment_sharded(u, p.replace(lambda1=5.0, lambda2=0.2), mesh,
                        max_iter=8, fixed=True)
    assert not np.array_equal(np.asarray(a.phi), np.asarray(b.phi))
    np.testing.assert_array_equal(np.asarray(a.phi), np.asarray(c.phi))


def test_sharded_reinit_steps_validated():
    """Review 2 finding 2: clear error when reinit_steps exceeds the shard
    size (the halo exchange only reaches immediate neighbors)."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 fake devices")
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    mesh = make_grid_mesh(2, 4)  # shards (32, 16)
    u = jnp.zeros((64, 64), F32)
    with pytest.raises(ValueError, match="reinit_steps"):
        segment_sharded(u, CVParams(reinit_every=5, reinit_steps=20), mesh)


def test_sharded_rejects_unknown_halo():
    """Only the collective halo schedules exist; anything else raises
    before tracing."""
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import (segment_multiphase_sharded,
                                            segment_sharded,
                                            segment_sharded_fixed_trace)

    mesh = make_grid_mesh(2, 2)
    u = jnp.zeros((64, 64), F32)
    for fn in (segment_sharded, segment_sharded_fixed_trace,
               segment_multiphase_sharded):
        with pytest.raises(ValueError, match="unknown halo"):
            fn(u, CVParams(), mesh, halo="rdma")


def test_checkpoint_ignores_torn_tmp(tmp_path):
    """Finding 4: a leftover torn temp file must never be 'latest'."""
    from chan_vese.utils import checkpoint

    checkpoint.save(tmp_path, 10, np.zeros((4, 4)))
    # simulate a torn write under both old and new temp conventions
    (tmp_path / "ckpt_00000020.tmp.npz").write_bytes(b"torn")
    (tmp_path / ".tmp_ckpt_00000030.npz").write_bytes(b"torn")
    assert checkpoint.latest(tmp_path).name == "ckpt_00000010.npz"
    state = checkpoint.load(checkpoint.latest(tmp_path))
    assert int(state["step"]) == 10


def test_checkpoint_chunking_preserves_reinit_cadence(tmp_path):
    """Finding 5: chunked runs keep the global reinit schedule."""
    from chan_vese import segment_fixed
    from chan_vese.utils import checkpoint

    img, _ = two_disks(32, 32, noise=4.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle", reinit_every=30, reinit_steps=10)
    phi_chunked = checkpoint.segment_with_checkpoints(
        u, p, iters=100, ckpt_dir=tmp_path, every=50)
    phi_straight = segment_fixed(u, p, iters=100).phi
    np.testing.assert_allclose(np.asarray(phi_chunked),
                               np.asarray(phi_straight),
                               rtol=1e-10, atol=1e-9)


def test_cli_multiphase_mesh_routes_sharded(tmp_path):
    """Finding 6: --multiphase + --mesh runs the sharded multiphase path."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 fake devices")
    from chan_vese.cli import main
    from chan_vese.utils import image_io
    from fixtures import four_regions

    img, _ = four_regions(64, 64, noise=4.0)
    src = tmp_path / "in.png"
    image_io._save_u8(src, np.clip(img, 0, 255).astype(np.uint8))
    out = tmp_path / "lab.png"
    rc = main([str(src), "--multiphase", "2", "--mesh", "2", "4",
               "--mu", "195", "--iters", "30", "-o", str(out), "--quiet"])
    assert rc == 0
    lab = image_io.load_image(out)
    assert len(np.unique(lab)) >= 3


def test_cli_gif_respects_iter_count(tmp_path):
    """Finding 7: the GIF replay must not overshoot --iters."""
    from chan_vese.cli import main
    from chan_vese.utils import image_io

    img, _ = two_disks(48, 48, noise=5.0)
    src = tmp_path / "in.png"
    image_io._save_u8(src, np.clip(img, 0, 255).astype(np.uint8))
    gif = tmp_path / "e.gif"
    # mu high enough that the contour is still moving at every snapshot
    # (identical consecutive frames get merged by the GIF writer)
    rc = main([str(src), "--iters", "7", "--gif-every", "3",
               "--mu", "3000", "--evolution-gif", str(gif), "--quiet"])
    assert rc == 0
    import imageio.v3 as iio
    frames = iio.imread(gif, index=None)
    assert len(frames) == 3  # chunks of 3, 3, 1 - no overshoot past 7


# ---------------------------------------------------------------------------
# Fifth-review findings
# ---------------------------------------------------------------------------

def test_drivers_honor_non_redblack_order():
    """Finding 5.1: order != 'redblack' runs that ordering in the
    tolerance and fixed drivers alike (same trajectory at the same
    iteration count)."""
    from chan_vese import segment
    from chan_vese.models.scalar import segment_fixed

    img, _ = two_disks(64, 128, noise=6.0)
    u = jnp.asarray(img, F32)
    for order in ("jacobi", "wavefront"):
        p = CVParams(init="circle", order=order, max_iter=8, tol=-1.0)
        a = segment(u, p)
        tr = segment_fixed(u, p, iters=8)
        assert int(a.iters) == 8
        np.testing.assert_allclose(np.asarray(a.phi), np.asarray(tr.phi),
                                   rtol=1e-6, atol=1e-5, err_msg=order)
        rb = segment_fixed(u, p.replace(order="redblack"), iters=8)
        assert not np.allclose(np.asarray(tr.phi), np.asarray(rb.phi))


def test_batched_honors_non_redblack_order():
    from chan_vese.models.batched import segment_stack_fixed
    from chan_vese.models.scalar import segment_fixed

    img, _ = two_disks(64, 128, noise=6.0)
    u = jnp.asarray(img, F32)
    stack = jnp.stack([u, u[::-1]])
    p = CVParams(init="circle", order="jacobi")
    phis, _ = segment_stack_fixed(stack, p, iters=6)
    for k in range(2):
        tr = segment_fixed(stack[k], p, iters=6)
        np.testing.assert_allclose(np.asarray(phis[k]), np.asarray(tr.phi),
                                   rtol=1e-6, atol=1e-5)


def test_unknown_conv_norm_raises_everywhere():
    """Finding 5.3: every driver rejects an unknown conv_norm (the sharded
    paths used to silently compute mean_abs)."""
    from chan_vese import segment
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    img, _ = two_disks(64, 128, noise=6.0)
    u = jnp.asarray(img, F32)
    p = CVParams(conv_norm="bogus")
    with pytest.raises(ValueError, match="conv_norm"):
        segment(u, p)
    with pytest.raises(ValueError, match="conv_norm"):
        segment_sharded(u, p, mesh=make_grid_mesh(2, 2))
    rgb = jnp.stack([u, u, u], axis=-1)
    with pytest.raises(ValueError, match="conv_norm"):
        segment_sharded(rgb, p, mesh=make_grid_mesh(2, 2))


def test_channel_lambdas_broadcasts_scalars():
    """Finding 5.2: scalar lambda overrides broadcast per-channel on vector
    images (used to raise TypeError)."""
    from chan_vese.models.vector import segment_vector_fixed

    p = CVParams()
    assert p.channel_lambdas(3, 2.0, None) == ((2.0,) * 3, (1.0,) * 3)
    assert p.channel_lambdas(2, None, 0.5) == ((1.0,) * 2, (0.5,) * 2)
    with pytest.raises(ValueError, match="length 3"):
        p.channel_lambdas(3, (1.0, 2.0), None)

    img, _ = two_disks(48, 64, noise=6.0)
    u = jnp.asarray(img, F32)
    rgb = jnp.stack([u, 0.5 * u, 255.0 - u], axis=-1)
    p2 = CVParams(init="circle")
    a = segment_vector_fixed(rgb, p2, iters=10, lambda1=2.0)
    b = segment_vector_fixed(rgb, p2, iters=10, lambda1=(2.0, 2.0, 2.0))
    assert np.array_equal(np.asarray(a.phi), np.asarray(b.phi))


def test_curvature_matches_coefficient_form():
    """Finding 5.5 refactor guard: curvature() (now via face_coeffs_all)
    still equals the explicit forward/backward coefficient expansion."""
    from chan_vese.ops.numerics import (curvature, face_coeffs,
                                        face_coeffs_backward, shift_down,
                                        shift_left, shift_right, shift_up)

    rng = np.random.default_rng(7)
    phi = jnp.asarray(rng.standard_normal((17, 23)), F64)
    A, B = face_coeffs(phi, 1.0, 1e-8)
    Am, Bm = face_coeffs_backward(phi, 1.0, 1e-8)
    ref = (A * (shift_down(phi) - phi) + Am * (shift_up(phi) - phi)
           + B * (shift_right(phi) - phi) + Bm * (shift_left(phi) - phi))
    np.testing.assert_array_equal(np.asarray(curvature(phi, 1e-8)),
                                  np.asarray(ref))
