"""The classic per-pixel delta-phi tolerances ('rms', 'mean_abs') through
every driver (the default 'flips' path is covered everywhere else)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese import CVParams, segment
from fixtures import iou, two_disks

F32 = jnp.float32


@pytest.mark.parametrize("norm", ["rms", "mean_abs"])
def test_jnp_driver_conv_norms(norm):
    img, gt = two_disks(64, 64, noise=6.0)
    # phi drifts ~t^(1/3) so delta decays slowly: pick a loose tol the
    # run reaches within the cap
    p = CVParams(init="circle", conv_norm=norm, tol=0.5, max_iter=200,
                 min_iter=30)
    res = segment(jnp.asarray(img, F32), p)
    assert int(res.iters) < 200
    assert iou(np.asarray(res.mask), gt) >= 0.98


@pytest.mark.parametrize("norm", ["rms", "mean_abs"])
def test_vector_driver_conv_norms(norm):
    from chan_vese import segment_vector

    img, gt = two_disks(64, 128, noise=6.0)
    rgb = np.stack([img, 0.8 * img + 20.0, img], axis=-1)
    p = CVParams(init="circle", conv_norm=norm, tol=0.5, max_iter=200,
                 min_iter=30)
    res = segment_vector(jnp.asarray(rgb, F32), p)
    assert int(res.iters) < 200
    assert iou(np.asarray(res.mask), gt) >= 0.98


@pytest.mark.parametrize("norm", ["rms", "mean_abs"])
def test_sharded_driver_conv_norms(norm):
    if jax.device_count() < 8:
        pytest.skip("needs 8 fake devices")
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    mesh = make_grid_mesh(2, 4)
    img, gt = two_disks(64, 64, noise=6.0)
    p = CVParams(init="circle", conv_norm=norm, tol=0.5, max_iter=200,
                 min_iter=30)
    res = segment_sharded(jnp.asarray(img, F32), p, mesh)
    assert int(res.iters) < 200
    assert iou(np.asarray(res.mask), gt) >= 0.98


def test_sharded_and_jnp_agree_on_rms_iteration_count():
    if jax.device_count() < 8:
        pytest.skip("needs 8 fake devices")
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    img, _ = two_disks(64, 128, noise=6.0)
    u = jnp.asarray(img, F32)
    p = CVParams(init="circle", conv_norm="rms", tol=0.5, max_iter=200,
                 min_iter=30)
    a = int(segment(u, p).iters)
    b = int(segment_sharded(u, p, make_grid_mesh(2, 4)).iters)
    assert abs(a - b) <= 2, (a, b)


def test_divergence_aborts_loop():
    """Failure detection (SURVEY.md §5): a non-finite image makes delta NaN
    on iteration 0; the tolerance loop must abort immediately instead of
    burning max_iter iterations."""
    import numpy as np

    from chan_vese import CVParams, segment
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    bad = jnp.full((64, 128), jnp.nan, jnp.float32)
    p = CVParams(conv_norm="rms", max_iter=200)
    for fn, kw in ((segment, {}),):
        r = fn(bad, p, **kw)
        assert int(r.iters) <= 2, fn
        assert np.isnan(float(r.delta)), fn
    r = segment_sharded(bad, p, mesh=make_grid_mesh(2, 2))
    assert int(r.iters) <= 2 and np.isnan(float(r.delta))


def test_divergence_aborts_loop_flips_norm():
    """ADVICE.md round-1 (medium): under the DEFAULT conv_norm='flips' a
    NaN phi yields zero sign flips, which used to read as instant
    convergence with a garbage all-False mask. The NaN-poisoned flip
    metric must abort instead."""
    import numpy as np

    from chan_vese import CVParams, segment
    from chan_vese.parallel.mesh import make_grid_mesh
    from chan_vese.parallel.sharded import segment_sharded

    bad = jnp.full((64, 128), jnp.nan, jnp.float32)
    p = CVParams(conv_norm="flips", max_iter=200, min_iter=0)
    for fn, kw in ((segment, {}),):
        r = fn(bad, p, **kw)
        assert int(r.iters) <= 2, fn
        assert not np.isfinite(float(r.delta)), fn
    r = segment_sharded(bad, p, mesh=make_grid_mesh(2, 2))
    assert int(r.iters) <= 2 and not np.isfinite(float(r.delta))


def test_divergence_aborts_multiphase_flips():
    """Multiphase label-flip metric must also NaN-poison (its labels are
    finite garbage on a NaN level set)."""
    import numpy as np

    from chan_vese import CVParams
    from chan_vese.models.multiphase import segment_multiphase

    bad = jnp.full((32, 32), jnp.nan, jnp.float32)
    p = CVParams(max_iter=100, min_iter=0)
    r = segment_multiphase(bad, p, m_sets=2)
    assert int(r.iters) <= 2
    assert not np.isfinite(float(r.delta))


def test_inf_delta_aborts_loop():
    """VERDICT.md weak #7: a delta that goes +Inf WITHOUT NaN (rms on
    overflow) must abort too - the predicate is ~isfinite, not isnan."""
    import numpy as np

    from chan_vese import CVParams, segment

    bad = jnp.full((64, 128), jnp.inf, jnp.float32)
    p = CVParams(conv_norm="rms", max_iter=200, min_iter=0)
    r = segment(bad, p)
    assert int(r.iters) <= 2
    assert not np.isfinite(float(r.delta))


def test_divergence_guard_does_not_stop_healthy_runs():
    """The guard must be inert on finite runs (initial delta is +inf)."""
    from chan_vese import CVParams, segment
    from fixtures import two_disks

    img, gt = two_disks(64, 128, noise=6.0)
    r = segment(jnp.asarray(img, jnp.float32), CVParams(init="circle"))
    assert int(r.iters) > 5
    m = (r.phi >= 0)
    import numpy as np
    inter = np.logical_and(np.asarray(m), gt).sum()
    union = np.logical_or(np.asarray(m), gt).sum()
    assert inter / union > 0.9
