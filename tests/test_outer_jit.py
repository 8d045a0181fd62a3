"""Outer-jit composability of the sharded drivers.

jax forbids `jax.set_mesh` inside a jit trace, so `segment_sharded` /
`segment_stack_sharded` detect a traced input and skip their internal
mesh context — the CALLER holds `with jax.set_mesh(mesh):` open around
the jitted call. bench_configs.py's single-dispatch timing depends on
this; it is also what lets a user embed a solve inside a larger jitted
pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese.params import CVParams
from chan_vese.parallel import mesh as meshmod
from chan_vese.parallel.sharded import segment_sharded, _make_phi0
from fixtures import two_disks

F64 = jnp.float64


@pytest.fixture(scope="module")
def grid_mesh():
    return meshmod.make_grid_mesh(2, 4)


@pytest.mark.parametrize("kwargs", [dict(), dict(comm_k=4)])
def test_sharded_outer_jit_matches_eager(grid_mesh, kwargs):
    """jit(segment_sharded) under a caller-held mesh == the eager call,
    bitwise in f64 (same program, same reduction trees)."""
    img, _ = two_disks(64, 64, noise=6.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle", reinit_every=0)
    phi0 = _make_phi0(u.shape, p.init, u.dtype, grid_mesh)

    ref = segment_sharded(u, p, grid_mesh, phi0=phi0, max_iter=12,
                          fixed=True, **kwargs)

    @jax.jit
    def run(u, phi0, r):
        res = segment_sharded(u + r, p, grid_mesh, phi0=phi0,
                              max_iter=12, fixed=True, **kwargs)
        return res.phi, res.c1, res.c2

    with jax.set_mesh(grid_mesh):
        phi, c1, c2 = run(u, phi0, jnp.float64(0))
    np.testing.assert_array_equal(np.asarray(phi), np.asarray(ref.phi))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(ref.c1))
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(ref.c2))


def test_sharded_outer_jit_requires_phi0(grid_mesh):
    img, _ = two_disks(64, 64, noise=6.0)
    u = jnp.asarray(img, F64)
    p = CVParams(init="circle", reinit_every=0)

    @jax.jit
    def run(u):
        return segment_sharded(u, p, grid_mesh, max_iter=2,
                               fixed=True).phi

    with jax.set_mesh(grid_mesh):
        with pytest.raises(ValueError, match="explicit phi0"):
            run(u)


def test_stack_sharded_outer_jit_matches_eager():
    from chan_vese.parallel.data_parallel import segment_stack_sharded

    dmesh = meshmod.make_data_mesh()
    rng = np.random.default_rng(0)
    stack = jnp.asarray(rng.uniform(0, 255, (8, 32, 32)), F64)
    p = CVParams(init="circle", reinit_every=0)

    ref_phi, ref_mask = segment_stack_sharded(stack, p, dmesh, iters=6)

    @jax.jit
    def run(s, r):
        return segment_stack_sharded(s + r, p, dmesh, iters=6)[0]

    with jax.set_mesh(dmesh):
        phi = run(stack, jnp.float64(0))
    np.testing.assert_array_equal(np.asarray(phi), np.asarray(ref_phi))
