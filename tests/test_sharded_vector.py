"""Vector-valued spatial sharding (RGB over the 2D mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.params import CVParams
from chan_vese.parallel import mesh as meshmod
from chan_vese.parallel.sharded import segment_sharded
from fixtures import colored_squares, iou

F32 = jnp.float32


@pytest.fixture(scope="module")
def grid_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (fake) devices")
    return meshmod.make_grid_mesh(2, 4)


def test_sharded_rgb_matches_unsharded(grid_mesh):
    from chan_vese.models.vector import segment_vector_fixed

    img, gt = colored_squares(64, 64, noise=4.0)
    u = jnp.asarray(img, F32)
    p = CVParams(init="circle")
    lam = (1.0, 1.2, 0.8)
    res = segment_sharded(u, p, grid_mesh, max_iter=15, fixed=True,
                          lambda1=lam)
    ref = segment_vector_fixed(u, p, iters=15, lambda1=lam)
    assert (np.asarray(res.mask) != np.asarray(ref.mask)).sum() <= 3
    assert res.c1.shape == (3,)


def test_sharded_rgb_single_iteration_tight(grid_mesh):
    from chan_vese.models.vector import segment_vector_fixed

    img, _ = colored_squares(64, 64, noise=4.0)
    u = jnp.asarray(img, jnp.float64)
    p = CVParams(init="circle")
    res = segment_sharded(u, p, grid_mesh, max_iter=2, fixed=True)
    ref = segment_vector_fixed(u, p, iters=2)
    np.testing.assert_allclose(np.asarray(res.phi), np.asarray(ref.phi),
                               rtol=1e-11, atol=1e-9)


def test_sharded_rgb_converges(grid_mesh):
    img, gt = colored_squares(64, 64, noise=4.0)
    p = CVParams(init="circle", max_iter=100)
    res = segment_sharded(jnp.asarray(img, F32), p, grid_mesh)
    assert int(res.iters) < 100
    assert iou(np.asarray(res.mask), gt) >= 0.97
