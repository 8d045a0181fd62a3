"""f32 summation accuracy at 4K scale (SURVEY.md §7 hard part "f32 vs
f64").

The 1e-5 relative energy-trace criterion (BASELINE.json:5) must survive
f32 reductions over 8.3 Mpixels. XLA reduces tree-wise (error ~ eps *
log2 N, about 3e-6 relative); this is pinned here against the f64 ground
truth at the full 4K eval shape, on the CPU and (marked ``gpu``) on the
GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese import CVParams
from chan_vese.ops.reductions import energy, means_from_sums, region_means
from chan_vese.utils.init_phi import checkerboard

H, W = 2160, 3840


@pytest.fixture(scope="module")
def big():
    rng = np.random.default_rng(7)
    u = rng.uniform(0.0, 255.0, (H, W))
    phi = np.asarray(checkerboard((H, W), jnp.float64))
    return u, phi


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def test_region_means_f32_vs_f64_at_4k(big):
    u, phi = big
    p = CVParams()
    c1_64, c2_64 = region_means(jnp.asarray(u, jnp.float64),
                                jnp.asarray(phi, jnp.float64), p.eps)
    c1_32, c2_32 = region_means(jnp.asarray(u, jnp.float32),
                                jnp.asarray(phi, jnp.float32), p.eps)
    assert _rel(c1_32, c1_64) < 1e-5
    assert _rel(c2_32, c2_64) < 1e-5


def test_energy_f32_vs_f64_at_4k(big):
    u, phi = big
    p = CVParams()
    u64, phi64 = jnp.asarray(u, jnp.float64), jnp.asarray(phi, jnp.float64)
    c1, c2 = region_means(u64, phi64, p.eps)
    e64 = energy(u64, phi64, c1, c2, p)
    e32 = energy(jnp.asarray(u, jnp.float32), jnp.asarray(phi, jnp.float32),
                 jnp.float32(c1), jnp.float32(c2), p)
    assert _rel(e32, e64) < 1e-5


def _step_sums_vs_f64(u, phi, device=None):
    """One f32 red-black iteration (models/scalar.step) at the 4K eval
    shape, then the f32 region sums of the new phi checked against f64
    sums of the SAME phi_new."""
    import jax

    from chan_vese.models.scalar import step
    from chan_vese.ops.reductions import region_sums

    p = CVParams()
    u32 = jax.device_put(np.asarray(u, np.float32), device)
    phi32 = jax.device_put(np.asarray(phi, np.float32), device)
    phi_new = jax.jit(lambda a, b: step(a, b, p)[0])(phi32, u32)
    s_uh, s_h, _, _ = region_sums(u32, phi_new, p.eps)
    pn = np.asarray(phi_new, np.float64)
    h64 = 0.5 + (1.0 / np.pi) * np.arctan(pn / p.eps)
    assert _rel(s_uh, float((u * h64).sum())) < 1e-5
    assert _rel(s_h, float(h64.sum())) < 1e-5
    c1, c2 = means_from_sums(*region_sums(u32, phi_new, p.eps))
    c1_64 = (u * h64).sum() / h64.sum()
    c2_64 = (u.sum() - (u * h64).sum()) / (H * W - h64.sum())
    assert _rel(c1, c1_64) < 1e-5
    assert _rel(c2, c2_64) < 1e-5


def test_step_sums_f32_vs_f64_at_4k(big):
    """XLA's f32 reduction order over 8.3 Mpixels after one iteration."""
    u, phi = big
    _step_sums_vs_f64(u, phi)


@pytest.mark.gpu
def test_gpu_step_sums_4k_vs_f64(big, gpu):
    """The same check with the iteration and the sums compiled for the
    GPU, whose reduction order differs from the CPU's."""
    u, phi = big
    _step_sums_vs_f64(u, phi, gpu)
