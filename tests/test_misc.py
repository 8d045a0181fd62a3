"""Coverage for mesh/profiling/multihost utils + numerical robustness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.params import CVParams
from chan_vese.parallel import mesh as meshmod
from chan_vese.parallel import multihost
from chan_vese.utils import profiling
from fixtures import two_disks


class TestMesh:
    def test_grid_mesh_shape(self):
        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        m = meshmod.make_grid_mesh(2, 4)
        assert m.shape == {"x": 2, "y": 4}
        assert meshmod.grid_sharding(m) is not None

    def test_grid_mesh_too_big_raises(self):
        with pytest.raises(ValueError):
            meshmod.make_grid_mesh(100, 100)

    def test_hybrid_mesh(self):
        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        m = meshmod.make_hybrid_mesh(2, 2, 2)
        assert m.shape == {"data": 2, "x": 2, "y": 2}


class TestProfiling:
    def test_time_fn(self):
        f = jax.jit(lambda x: x * 2)
        t, out = profiling.time_fn(f, jnp.ones((8, 8)), reps=2)
        assert t > 0
        np.testing.assert_allclose(np.asarray(out), 2.0)

    def test_roofline(self):
        # 3350 GB/s at 12 B/pixel-iter -> ~279 Gpix-iter/s ceiling
        assert profiling.roofline(2160, 3840, 3350.0) == pytest.approx(
            279166.7, rel=0.01)

    def test_trace_context(self, tmp_path):
        with profiling.trace(str(tmp_path / "tr")):
            jax.block_until_ready(jax.jit(lambda x: x + 1)(jnp.ones(4)))
        assert any((tmp_path / "tr").rglob("*"))


class TestMultihost:
    def test_single_process_noop(self):
        multihost.initialize()
        assert multihost.is_coordinator()


class TestRobustness:
    """No NaN/Inf escapes under extreme parameter settings."""

    @pytest.mark.parametrize("params", [
        dict(mu=0.0),                      # no regularization
        dict(mu=1e6),                      # crushing regularization
        dict(dt=50.0),                     # huge step (semi-implicit)
        dict(eps=1e-3),                    # near-sharp Heaviside
        dict(eps=100.0),                   # very smooth Heaviside
        dict(nu=1e4),                      # strong area penalty
        dict(eta2=1e-16),
    ])
    def test_finite(self, params):
        from chan_vese import segment_fixed

        img, _ = two_disks(32, 32, noise=6.0)
        p = CVParams(init="circle", **params)
        tr = segment_fixed(jnp.asarray(img, jnp.float32), p, iters=50)
        assert bool(jnp.isfinite(tr.phi).all()), params
        assert bool(jnp.isfinite(tr.energy).all()), params

    def test_constant_image(self):
        from chan_vese import segment

        u = jnp.full((32, 32), 128.0, jnp.float32)
        res = segment(u, CVParams(init="circle", max_iter=50))
        assert bool(jnp.isfinite(res.phi).all())

    def test_tiny_image(self):
        from chan_vese import segment_fixed

        u = jnp.asarray(np.random.default_rng(0).uniform(0, 255, (4, 5)),
                        jnp.float32)
        tr = segment_fixed(u, CVParams(), iters=10)
        assert bool(jnp.isfinite(tr.phi).all())


def test_every_driver_runs_finite_on_cpu():
    """Every single-device driver runs on the CPU backend at shapes with
    unaligned heights, RGB channels and a frame axis (the examples and
    the CLI run these on machines without an accelerator)."""
    import jax.numpy as jnp
    import numpy as np

    from chan_vese import (segment, segment_batch, segment_fixed,
                           segment_multiphase, segment_stack_fixed,
                           segment_vector)
    from chan_vese.params import CVParams

    rng = np.random.default_rng(0)
    p = CVParams()
    u = jnp.asarray(rng.uniform(0, 255, (24, 128)), jnp.float32)
    urgb = jnp.asarray(rng.uniform(0, 255, (24, 128, 3)), jnp.float32)
    stack = jnp.asarray(rng.uniform(0, 255, (2, 24, 128)), jnp.float32)
    p3 = CVParams(max_iter=3)
    outs = [segment(u, p3).phi, segment(urgb, p3).phi,
            segment_fixed(u, p, iters=3).phi,
            segment_vector(urgb, p3).phi,
            segment_stack_fixed(stack, p, iters=3)[0],
            segment_batch(stack, p3).phi,
            segment_multiphase(u, p3).phis]
    for out in outs:
        assert bool(jnp.isfinite(out).all())
