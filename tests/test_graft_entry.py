"""The entry contract (__graft_entry__.py) must keep working: entry()
jits and computes the scalar step, dryrun_multichip runs the DP+SP
sharded step. Caught by a real regression (a _sharded_iteration signature
change broke the dry run)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def test_entry_jits():
    from __graft_entry__ import entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_entry_step_matches_numpy():
    """entry()'s step is one red-black iteration: check it against the
    vectorised numpy reference."""
    from __graft_entry__ import entry
    from chan_vese.ops import sweep_np
    from chan_vese.params import CVParams

    fn, (phi0, u0, c1, c2) = entry()
    phi_new, stats = jax.jit(fn)(phi0, u0, c1, c2)
    p = CVParams()
    u, phi = np.asarray(u0, np.float64), np.asarray(phi0, np.float64)
    n1, n2 = sweep_np.region_means(u, phi, p.eps)
    np.testing.assert_allclose(np.asarray(stats[:2]), [n1, n2], rtol=1e-5)
    f = sweep_np.data_term(u, n1, n2, p.nu, p.lambda1, p.lambda2)
    want = sweep_np.redblack_sweep_vec(phi, f, p.mu, p.dt, p.eps, p.eta2)
    scale = float(np.abs(want).max()) + 1.0
    np.testing.assert_allclose(np.asarray(phi_new), want, rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip(n):
    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices")
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(n)


@pytest.mark.parametrize("n,want", [(1, (1, 1, 1)), (6, (2, 1, 3)),
                                    (8, (2, 2, 2)), (12, (3, 2, 2)),
                                    (7, (7, 1, 1))])
def test_factor3_mesh_shapes(n, want):
    from __graft_entry__ import _factor3

    assert _factor3(n) == want


def test_dryrun_rejects_too_few_devices():
    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs"):
        dryrun_multichip(jax.device_count() + 1)
