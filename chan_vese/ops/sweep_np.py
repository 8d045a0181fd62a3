"""Straight-line NumPy transcription of the sequential raster Gauss-Seidel
sweep (f64) - the golden reference for the order-equivalence and parity
tests (SURVEY.md §4.1).

This is a deliberately naive per-cell double loop, written independently of
the vectorized jnp code so the two can cross-check each other. The C
baseline in native/cv_baseline.c implements the same convention a third
time. Convention notes (shared by all implementations in this repo):

  * Neumann boundaries are replica-eval (Getreuer IPOL 2012 /
    pad-then-compute lineage): every neighbor *value* read clamps to the
    grid, so out-of-range DIFFERENCES vanish - including inside the
    backward face coefficients A-, B- (A-[0, j] has a zero
    forward-difference term), matching ``face_coeffs_backward`` in
    ops/numerics.py. This is the convention that spatial sharding with
    edge-replicate halos reproduces exactly.
  * Raster order: row-major, in place, so reads at (i-1, j-1), (i-1, j),
    (i-1, j+1) and (i, j-1) see already-updated values.
"""

from __future__ import annotations

import math

import numpy as np


def _cell_update(at, f_ij, i, j, mu, dt, eps, eta2):
    """The per-cell semi-implicit update given a clamped reader ``at``."""
    # forward face coefficients at (i+1/2, j) and (i, j+1/2)
    dxp = at(i + 1, j) - at(i, j)
    dy0 = 0.5 * (at(i, j + 1) - at(i, j - 1))
    A = mu / math.sqrt(eta2 + dxp * dxp + dy0 * dy0)
    dx0 = 0.5 * (at(i + 1, j) - at(i - 1, j))
    dyp = at(i, j + 1) - at(i, j)
    B = mu / math.sqrt(eta2 + dx0 * dx0 + dyp * dyp)
    # backward coefficients, replica-eval: clamped VALUE reads only, so
    # the forward-difference terms vanish at the boundary
    dxm = at(i, j) - at(i - 1, j)
    dy0m = 0.5 * (at(i - 1, j + 1) - at(i - 1, j - 1))
    Am = mu / math.sqrt(eta2 + dxm * dxm + dy0m * dy0m)
    dym = at(i, j) - at(i, j - 1)
    dx0m = 0.5 * (at(i + 1, j - 1) - at(i - 1, j - 1))
    Bm = mu / math.sqrt(eta2 + dx0m * dx0m + dym * dym)

    z = at(i, j)
    d = (eps / math.pi) / (eps * eps + z * z)
    num = z + dt * d * (A * at(i + 1, j) + Am * at(i - 1, j)
                        + B * at(i, j + 1) + Bm * at(i, j - 1) + f_ij)
    den = 1.0 + dt * d * (A + Am + B + Bm)
    return num / den


def raster_sweep(phi: np.ndarray, f: np.ndarray, mu: float, dt: float,
                 eps: float, eta2: float) -> np.ndarray:
    """One in-place raster Gauss-Seidel sweep. Returns ``phi`` (modified)."""
    H, W = phi.shape

    def at(i, j):
        return phi[min(max(i, 0), H - 1), min(max(j, 0), W - 1)]

    for i in range(H):
        for j in range(W):
            phi[i, j] = _cell_update(at, f[i, j], i, j, mu, dt, eps, eta2)
    return phi


def redblack_sweep(phi: np.ndarray, f: np.ndarray, mu: float, dt: float,
                   eps: float, eta2: float) -> np.ndarray:
    """Red-black ordered sweep matching ops/sweep.py:redblack_step.

    Red cells ((i + j) even) update from the all-old state; black cells
    from the red-updated state. Vectorization-free transcription used to
    validate the jnp fast path.
    """
    H, W = phi.shape
    out = phi
    for color in (0, 1):
        base = out  # frozen state this half-sweep reads from

        def at(i, j, base=base):
            return base[min(max(i, 0), H - 1), min(max(j, 0), W - 1)]

        nxt = base.copy()
        for i in range(H):
            for j in range(W):
                if (i + j) % 2 != color:
                    continue
                nxt[i, j] = _cell_update(at, f[i, j], i, j, mu, dt, eps,
                                         eta2)
        out = nxt
    return out


# ---------------------------------------------------------------------------
# Vectorised NumPy references (f64). Same conventions as the loops above,
# written with edge-padded slices so they run at realistic sizes; the tests
# pin them against the loops on small grids and use them as the plain
# reference for the jnp drivers (which they share no code with).
# ---------------------------------------------------------------------------

def update_all_vec(phi, f, mu, dt, eps, eta2):
    """The semi-implicit update at every cell from state ``phi``."""
    P = np.pad(np.asarray(phi, np.float64), 1, mode="edge")
    c = P[1:-1, 1:-1]
    up, dn = P[:-2, 1:-1], P[2:, 1:-1]
    lf, rt = P[1:-1, :-2], P[1:-1, 2:]
    ul, ur, dl = P[:-2, :-2], P[:-2, 2:], P[2:, :-2]
    A = mu / np.sqrt(eta2 + (dn - c) ** 2 + (0.5 * (rt - lf)) ** 2)
    B = mu / np.sqrt(eta2 + (0.5 * (dn - up)) ** 2 + (rt - c) ** 2)
    Am = mu / np.sqrt(eta2 + (c - up) ** 2 + (0.5 * (ur - ul)) ** 2)
    Bm = mu / np.sqrt(eta2 + (0.5 * (dl - ul)) ** 2 + (c - lf) ** 2)
    d = (eps / math.pi) / (eps * eps + c * c)
    num = c + dt * d * (A * dn + Am * up + B * rt + Bm * lf + f)
    den = 1.0 + dt * d * (A + Am + B + Bm)
    return num / den


def redblack_sweep_vec(phi, f, mu, dt, eps, eta2):
    """Vectorised twin of ``redblack_sweep``: red cells ((i + j) even)
    from the old state, then black cells from the red-updated state."""
    phi = np.asarray(phi, np.float64)
    i, j = np.indices(phi.shape)
    red = (i + j) % 2 == 0
    out = np.where(red, update_all_vec(phi, f, mu, dt, eps, eta2), phi)
    return np.where(red, out, update_all_vec(out, f, mu, dt, eps, eta2))


def heaviside(z, eps):
    return 0.5 * (1.0 + (2.0 / math.pi) * np.arctan(z / eps))


def region_means(u0, phi, eps):
    """c1 (inside, H_eps(phi)-weighted) and c2 (outside); per channel for
    (H, W, C) images."""
    u0 = np.asarray(u0, np.float64)
    h = heaviside(np.asarray(phi, np.float64), eps)
    hh = h[..., None] if u0.ndim == 3 else h
    s_uh = (u0 * hh).sum(axis=(0, 1))
    s_u = u0.sum(axis=(0, 1))
    s_h = h.sum()
    c1 = s_uh / max(s_h, 1e-30)
    c2 = (s_u - s_uh) / max(h.size - s_h, 1e-30)
    return c1, c2


def _lambdas(u0, p, lambda1, lambda2):
    l1 = p.lambda1 if lambda1 is None else lambda1
    l2 = p.lambda2 if lambda2 is None else lambda2
    if np.ndim(u0) == 3:
        shape = (np.shape(u0)[-1],)
        return (np.broadcast_to(np.asarray(l1, np.float64), shape),
                np.broadcast_to(np.asarray(l2, np.float64), shape))
    return float(np.atleast_1d(l1)[0]), float(np.atleast_1d(l2)[0])


def data_term(u0, c1, c2, nu, l1, l2):
    """f = -nu - l1 (u0 - c1)^2 + l2 (u0 - c2)^2, channel-averaged for
    (H, W, C) images."""
    u0 = np.asarray(u0, np.float64)
    if u0.ndim == 3:
        return (-nu - np.mean(l1 * (u0 - c1) ** 2, axis=-1)
                + np.mean(l2 * (u0 - c2) ** 2, axis=-1))
    return -nu - l1 * (u0 - c1) ** 2 + l2 * (u0 - c2) ** 2


def energy(u0, phi, c1, c2, p, l1, l2):
    """Chan-Vese energy with clamped forward differences for |grad phi|."""
    u0 = np.asarray(u0, np.float64)
    phi = np.asarray(phi, np.float64)
    P = np.pad(phi, ((0, 1), (0, 1)), mode="edge")
    gx = P[1:, :-1] - phi
    gy = P[:-1, 1:] - phi
    h = heaviside(phi, p.eps)
    dirac = (p.eps / math.pi) / (p.eps ** 2 + phi * phi)
    length = np.sum(dirac * np.sqrt(gx * gx + gy * gy))
    if u0.ndim == 3:
        fit1 = np.sum(np.mean(l1 * (u0 - c1) ** 2, axis=-1) * h)
        fit2 = np.sum(np.mean(l2 * (u0 - c2) ** 2, axis=-1) * (1.0 - h))
    else:
        fit1 = l1 * np.sum((u0 - c1) ** 2 * h)
        fit2 = l2 * np.sum((u0 - c2) ** 2 * (1.0 - h))
    return p.mu * length + p.nu * np.sum(h) + fit1 + fit2


def segment_fixed(u0, p, iters, phi0, lambda1=None, lambda2=None):
    """Fixed-iteration red-black Chan-Vese with per-iteration means.

    Returns (phi, energy, c1, c2): the energy after each sweep (means
    recomputed from the post-sweep phi) and the means each sweep used -
    the trace convention of models/scalar.segment_fixed.
    """
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)
    phi = np.asarray(phi0, np.float64)
    es, c1s, c2s = [], [], []
    for _ in range(iters):
        c1, c2 = region_means(u0, phi, p.eps)
        f = data_term(u0, c1, c2, p.nu, l1, l2)
        phi = redblack_sweep_vec(phi, f, p.mu, p.dt, p.eps, p.eta2)
        n1, n2 = region_means(u0, phi, p.eps)
        es.append(energy(u0, phi, n1, n2, p, l1, l2))
        c1s.append(c1)
        c2s.append(c2)
    return phi, np.asarray(es), np.asarray(c1s), np.asarray(c2s)


def segment_chunked(u0, p, iters, phi0, k, lambda1=None, lambda2=None):
    """Frozen-means-per-chunk red-black run: the means (and the data
    term) are computed once per chunk of ``k`` sweeps from the chunk's
    starting phi; the last chunk may be shorter. k = 1 is
    ``segment_fixed``'s trajectory."""
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)
    phi = np.asarray(phi0, np.float64)
    n = 0
    while n < iters:
        c1, c2 = region_means(u0, phi, p.eps)
        f = data_term(u0, c1, c2, p.nu, l1, l2)
        for _ in range(min(k, iters - n)):
            phi = redblack_sweep_vec(phi, f, p.mu, p.dt, p.eps, p.eta2)
        n += k
    return phi


def _phase_weights(hs, skip=None):
    """The 2^M soft phase indicators (bit m of s set <=> inside phi_m),
    leaving out level set ``skip``."""
    ws = []
    for s in range(2 ** len(hs)):
        w = np.ones(hs[0].shape)
        for m, h in enumerate(hs):
            if m != skip:
                w = w * (h if (s >> m) & 1 else 1.0 - h)
        ws.append(w)
    return ws


def phase_means(u0, phis, eps):
    """Means c_s of u0 over each soft phase (per channel for RGB)."""
    u0 = np.asarray(u0, np.float64)
    cs = []
    for w in _phase_weights([heaviside(np.asarray(x, np.float64), eps)
                             for x in phis]):
        ww = w[..., None] if u0.ndim == 3 else w
        cs.append((u0 * ww).sum(axis=(0, 1)) / max(w.sum(), 1e-30))
    return cs


def segment_multiphase(u0, p, iters, phis0, k=1):
    """``iters`` coupled iterations; the phase means are frozen for
    chunks of ``k`` iterations (k = 1: refreshed every iteration)."""
    phis = np.asarray(phis0, np.float64)
    cs = None
    for n in range(iters):
        if n % k == 0:
            cs = phase_means(u0, phis, p.eps)
        phis, _ = multiphase_step(phis, u0, p, cs)
    return phis


def multiphase_step(phis, u0, p, cs=None):
    """One Vese-Chan iteration: 2^M phase means from the current level
    sets (or the given ``cs``), then M sequential red-black sweeps (level
    set m sees the already-updated level sets < m through the coupling
    term). Returns (phis, the means used)."""
    u0 = np.asarray(u0, np.float64)
    new = [np.asarray(x, np.float64) for x in phis]
    m_sets = len(new)

    def sqdist(c):
        d = (u0 - c) ** 2
        return d.mean(axis=-1) if u0.ndim == 3 else d

    if cs is None:
        cs = phase_means(u0, new, p.eps)
    for m in range(m_sets):
        hs = [heaviside(x, p.eps) for x in new]
        f = -p.nu + sum((-1.0 if (s >> m) & 1 else 1.0) * sqdist(cs[s]) * w
                        for s, w in enumerate(_phase_weights(hs, skip=m)))
        new[m] = redblack_sweep_vec(new[m], f, p.mu, p.dt, p.eps, p.eta2)
    return np.stack(new), cs
