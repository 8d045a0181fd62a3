"""chan_vese() one-call convenience API."""

import numpy as np
import pytest

from chan_vese import chan_vese
from fixtures import colored_squares, iou, two_disks


def test_gray_default():
    img, gt = two_disks(64, 64, noise=6.0)
    mask = chan_vese(img, init_level_set="circle")
    assert iou(mask, gt) >= 0.99


def test_unit_range_normalized():
    img, gt = two_disks(64, 64, noise=6.0)
    mask = chan_vese(img / 255.0, init_level_set="circle")
    assert iou(mask, gt) >= 0.99


def test_rgb_with_lambdas():
    img, gt = colored_squares(64, 64, noise=4.0)
    mask = chan_vese(img, lambda1=(1.0, 1.2, 0.8),
                     init_level_set="circle")
    assert iou(mask, gt) >= 0.97


def test_extended_output():
    img, gt = two_disks(48, 48, noise=5.0)
    mask, phi, res = chan_vese(img, init_level_set="circle",
                               extended_output=True)
    assert phi.shape == mask.shape == img.shape
    assert int(res.iters) > 0


def test_init_level_set_array():
    """skimage-compat: a custom phi0 array as init_level_set."""
    import numpy as np

    from chan_vese.compat import chan_vese
    from chan_vese.utils.init_phi import init_phi
    from fixtures import iou, two_disks

    img, gt = two_disks(64, 128, noise=6.0)
    phi0 = np.asarray(init_phi((64, 128), "circle"))
    mask, phi, res = chan_vese(img, max_num_iter=120, init_level_set=phi0,
                               extended_output=True)
    assert iou(mask, gt) > 0.9
    with pytest.raises(ValueError, match="does not match"):
        chan_vese(img, init_level_set=np.zeros((8, 8), np.float32))


def test_disk_init_aliases():
    import numpy as np

    from chan_vese.utils.init_phi import init_phi

    d = np.asarray(init_phi((64, 64), "disk"))
    c = np.asarray(init_phi((64, 64), "circle"))
    np.testing.assert_array_equal(d, c)
    s = np.asarray(init_phi((64, 64), "small disk"))
    assert (s > 0).sum() < (d > 0).sum()  # smaller inside region
    np.testing.assert_array_equal(
        s, np.asarray(init_phi((64, 64), "small-disk")))
