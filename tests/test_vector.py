"""Vector-valued (RGB) Chan-Vese tests (eval config 2, BASELINE.json:8)."""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese import CVParams
from chan_vese.models.vector import segment_vector, segment_vector_fixed
from fixtures import colored_squares, iou

F64 = jnp.float64


def test_rgb_squares_segmentation():
    img, gt = colored_squares(64, 64, noise=5.0)
    p = CVParams(init="circle")
    res = segment_vector(jnp.asarray(img, F64), p)
    assert res.c1.shape == (3,) and res.c2.shape == (3,)
    assert iou(np.asarray(res.mask), gt) >= 0.98
    assert int(res.iters) < p.max_iter


def test_rgb_512_config2():
    """Eval config 2: 512x512 color image, per-channel lambda weights."""
    img, gt = colored_squares(512, 512, noise=5.0)
    p = CVParams(init="circle")
    res = segment_vector(jnp.asarray(img, jnp.float32), p,
                         lambda1=(1.0, 1.2, 0.8), lambda2=(1.0, 1.0, 1.0))
    assert iou(np.asarray(res.mask), gt) >= 0.98


def test_per_channel_lambda_selects_channel():
    """Zeroing all but one channel's weights reduces to scalar CV on that
    channel (up to the 1/C averaging of the vector energy)."""
    from chan_vese import segment_fixed

    img, gt = colored_squares(48, 48, noise=3.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    # weight only the red channel; 1/C=1/3 averaging rescales the data term,
    # compensate by tripling the lambdas
    res_vec = segment_vector_fixed(u, p, iters=40,
                                   lambda1=(3.0, 0.0, 0.0),
                                   lambda2=(3.0, 0.0, 0.0))
    res_scalar = segment_fixed(u[..., 0], p, iters=40)
    np.testing.assert_array_equal(np.asarray(res_vec.mask),
                                  np.asarray(res_scalar.mask))


def test_energy_decreases_rgb():
    img, _ = colored_squares(48, 48, noise=3.0)
    tr = segment_vector_fixed(jnp.asarray(img, F64),
                              CVParams(init="circle"), iters=60)
    e = np.asarray(tr.energy)
    assert float((np.diff(e) / np.abs(e[:-1])).max()) < 1e-6


def test_gray_stack_equals_scalar():
    """An RGB image with identical channels must reproduce the scalar path
    exactly (same means, same data term, same sweep)."""
    from chan_vese import segment_fixed
    from fixtures import two_disks

    img, _ = two_disks(32, 32, noise=4.0)
    u3 = jnp.asarray(np.stack([img] * 3, axis=-1), F64)
    u1 = jnp.asarray(img, F64)
    p = CVParams(init="circle")
    tr3 = segment_vector_fixed(u3, p, iters=30)
    tr1 = segment_fixed(u1, p, iters=30)
    # identical in exact arithmetic; the channel mean introduces ~1 ulp
    # differences that the sharp-interface dynamics amplify, so compare
    # masks exactly and phi/energy loosely
    np.testing.assert_array_equal(np.asarray(tr3.mask), np.asarray(tr1.mask))
    np.testing.assert_allclose(np.asarray(tr3.energy),
                               np.asarray(tr1.energy), rtol=1e-3)
