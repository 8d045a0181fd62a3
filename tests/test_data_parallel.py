"""Data-parallel stack tests on the fake 8-device mesh (eval config 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.parallel import mesh as meshmod
from chan_vese.parallel.data_parallel import (segment_stack_sharded,
                                              shard_stack)
from chan_vese.params import CVParams
from fixtures import iou, two_disks

F32 = jnp.float32


@pytest.fixture(scope="module")
def data_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (fake) devices")
    return meshmod.make_data_mesh(8)


def _stack(n, h=48, w=48):
    frames, gts = [], []
    for k in range(n):
        img, gt = two_disks(h, w, noise=6.0, seed=k)
        frames.append(img)
        gts.append(gt)
    return np.stack(frames).astype(np.float32), gts


def test_sharded_stack_matches_local(data_mesh):
    from chan_vese.models.batched import segment_stack_fixed

    stack, gts = _stack(8)
    u = jnp.asarray(stack)
    p = CVParams(init="circle")
    phis_sh, masks_sh = segment_stack_sharded(u, p, data_mesh, iters=25)
    # placement must actually be sharded over 'data'
    assert len(phis_sh.sharding.device_set) == 8
    phis, masks = segment_stack_fixed(u, p, iters=25)
    np.testing.assert_array_equal(np.asarray(masks_sh), np.asarray(masks))
    for k, gt in enumerate(gts):
        assert iou(np.asarray(masks_sh[k]), gt) >= 0.98


def test_sharded_stack_tol_mode(data_mesh):
    stack, gts = _stack(8)
    p = CVParams(init="circle", max_iter=100)
    res = segment_stack_sharded(jnp.asarray(stack), p, data_mesh)
    assert res.iters.shape == (8,)
    for k, gt in enumerate(gts):
        assert iou(np.asarray(res.mask[k]), gt) >= 0.98


def test_indivisible_batch_raises(data_mesh):
    with pytest.raises(ValueError):
        shard_stack(jnp.zeros((7, 16, 16), F32), data_mesh)


def test_sharded_stack_matches_numpy(data_mesh):
    """Every frame of the data-parallel fixed run == the numpy
    red-black trajectory of that frame alone (f64; 20 iterations amplify
    summation-order differences in the means to ~2e-8 relative)."""
    from chan_vese.ops import sweep_np
    from chan_vese.utils.init_phi import init_phi

    stack, gts = _stack(8, h=64, w=128)
    stack = np.asarray(stack, np.float64)
    p = CVParams(init="circle")
    phis, masks = segment_stack_sharded(jnp.asarray(stack), p, data_mesh,
                                        iters=20)
    phi0 = np.asarray(init_phi((64, 128), p.init, jnp.float64))
    for k, gt in enumerate(gts):
        want, _, _, _ = sweep_np.segment_fixed(stack[k], p, 20, phi0)
        np.testing.assert_allclose(np.asarray(phis[k]), want, rtol=1e-7,
                                   atol=1e-7)
        assert iou(np.asarray(masks[k]), gt) >= 0.98
