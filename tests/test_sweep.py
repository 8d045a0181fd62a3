"""Sweep-ordering tests (SURVEY.md §4.1): the load-bearing parity checks.

* straight-line NumPy raster GS  ==  jnp wavefront step   (exact schedule)
* straight-line NumPy red-black  ==  jnp redblack_step    (same operator)
* all orderings share the same fixed point (converged states agree)
"""

import jax.numpy as jnp
import numpy as np

from chan_vese.ops import sweep, sweep_np
from chan_vese.ops.reductions import data_term, region_means
from chan_vese.params import CVParams

F64 = jnp.float64


def _fixture(h=12, w=15, seed=0):
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(size=(h, w))
    phi = rng.standard_normal((h, w)) * 0.8
    f = (-0.1 - (u0 - 0.7) ** 2 + (u0 - 0.2) ** 2)
    return u0, phi, f


def test_wavefront_equals_raster_gs():
    """The skewed-diagonal schedule reproduces sequential raster GS."""
    _, phi, f = _fixture()
    p = CVParams(mu=0.25, dt=0.5, eps=1.0, eta2=1e-8, order="wavefront")
    got = np.asarray(sweep.wavefront_step(
        jnp.asarray(phi, F64), jnp.asarray(f, F64), p))
    want = sweep_np.raster_sweep(phi.astype(np.float64).copy(),
                                 f.astype(np.float64), p.mu, p.dt, p.eps,
                                 p.eta2)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)


def test_wavefront_equals_raster_gs_multiple_sweeps():
    _, phi, f = _fixture(h=9, w=8, seed=3)
    p = CVParams(mu=0.4, dt=0.8, eps=1.5, eta2=1e-8)
    cur = jnp.asarray(phi, F64)
    ref = phi.astype(np.float64).copy()
    for _ in range(3):
        cur = sweep.wavefront_step(cur, jnp.asarray(f, F64), p)
        sweep_np.raster_sweep(ref, f.astype(np.float64), p.mu, p.dt, p.eps,
                              p.eta2)
    np.testing.assert_allclose(np.asarray(cur), ref, rtol=1e-12, atol=1e-13)


def test_redblack_matches_numpy_transcription():
    _, phi, f = _fixture(h=11, w=13, seed=1)
    p = CVParams(mu=0.3, dt=0.6, eps=1.0, eta2=1e-8)
    got = np.asarray(sweep.redblack_step(
        jnp.asarray(phi, F64), jnp.asarray(f, F64), p))
    want = sweep_np.redblack_sweep(phi.astype(np.float64), f.astype(np.float64),
                                   p.mu, p.dt, p.eps, p.eta2)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)


def test_jacobi_matches_manual():
    """Jacobi == masked-update formula applied everywhere from old state."""
    _, phi, f = _fixture(h=8, w=8, seed=2)
    p = CVParams()
    got = np.asarray(sweep.jacobi_step(jnp.asarray(phi, F64),
                                       jnp.asarray(f, F64), p))
    # manual: every cell from old values == raster formula but frozen reads
    H, W = phi.shape
    base = phi.astype(np.float64)
    want = np.empty_like(base)

    def at(i, j):
        return base[min(max(i, 0), H - 1), min(max(j, 0), W - 1)]

    def acoef(i, j):
        return p.mu / np.sqrt(p.eta2 + (at(i + 1, j) - at(i, j)) ** 2
                              + (0.5 * (at(i, j + 1) - at(i, j - 1))) ** 2)

    def amcoef(i, j):
        return p.mu / np.sqrt(p.eta2 + (at(i, j) - at(i - 1, j)) ** 2
                              + (0.5 * (at(i - 1, j + 1)
                                        - at(i - 1, j - 1))) ** 2)

    def bcoef(i, j):
        return p.mu / np.sqrt(p.eta2 + (0.5 * (at(i + 1, j) - at(i - 1, j))) ** 2
                              + (at(i, j + 1) - at(i, j)) ** 2)

    def bmcoef(i, j):
        return p.mu / np.sqrt(p.eta2 + (0.5 * (at(i + 1, j - 1)
                                               - at(i - 1, j - 1))) ** 2
                              + (at(i, j) - at(i, j - 1)) ** 2)

    for i in range(H):
        for j in range(W):
            A, Am = acoef(i, j), amcoef(i, j)
            B, Bm = bcoef(i, j), bmcoef(i, j)
            z = base[i, j]
            d = (p.eps / np.pi) / (p.eps ** 2 + z ** 2)
            num = z + p.dt * d * (A * at(i + 1, j) + Am * at(i - 1, j)
                                  + B * at(i, j + 1) + Bm * at(i, j - 1)
                                  + f[i, j])
            den = 1 + p.dt * d * (A + Am + B + Bm)
            want[i, j] = num / den
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)


def test_full_loop_orderings_agree_on_mask():
    """Full nonlinear loop at the canonical [0,255] operating point:
    orderings differ in trajectory but must produce the same segmentation
    of a clean two-region image."""
    rng = np.random.default_rng(6)
    u0 = np.full((24, 24), 38.0)
    u0[6:18, 6:18] = 217.0
    u0 += 4.0 * rng.standard_normal(u0.shape)
    p = CVParams()
    # circle init pins polarity and is well-conditioned
    i, j = np.mgrid[0:24, 0:24].astype(np.float64)
    phi0 = 6.0 - np.hypot(i - 11.5, j - 11.5)
    masks = {}
    for order in ("jacobi", "redblack", "wavefront"):
        po = p.replace(order=order)
        cur = jnp.asarray(phi0, F64)
        uj = jnp.asarray(u0, F64)
        for _ in range(40):
            c1, c2 = region_means(uj, cur, p.eps)
            f = data_term(uj, c1, c2, p.nu, p.lambda1, p.lambda2)
            cur = sweep.semi_implicit_step(cur, f, po)
        masks[order] = np.asarray(cur) >= 0
    np.testing.assert_array_equal(masks["redblack"], masks["wavefront"])
    np.testing.assert_array_equal(masks["jacobi"], masks["wavefront"])


def test_parity_offset_shifts_lattice():
    _, phi, f = _fixture(h=6, w=6, seed=7)
    p = CVParams()
    a = sweep.redblack_step(jnp.asarray(phi, F64), jnp.asarray(f, F64), p, 0)
    b = sweep.redblack_step(jnp.asarray(phi, F64), jnp.asarray(f, F64), p, 1)
    assert not np.allclose(np.asarray(a), np.asarray(b))
    # offset 2 == offset 0
    c = sweep.redblack_step(jnp.asarray(phi, F64), jnp.asarray(f, F64), p, 2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
