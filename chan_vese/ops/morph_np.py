"""Independent NumPy transcription of the morphological schemes (f64).

The plain reference for the MorphACWE / MorphGAC drivers (Marquez-Neila,
Baumela, Alvarez, PAMI 2014), written with index clamps instead of the
shift primitives of ops/morph.py, under the same replica/Neumann edge
convention. The level set is binary, so the jnp drivers must match it
exactly on seeded inputs (a data force within one reduction-order ulp of
zero is the only way to differ, measure-zero for continuous random
images).
"""

from __future__ import annotations

import numpy as np


def shift(a, di: int, dj: int):
    """a[clamp(i + di), clamp(j + dj)]."""
    H, W = a.shape
    i = np.clip(np.arange(H) + di, 0, H - 1)
    j = np.clip(np.arange(W) + dj, 0, W - 1)
    return a[np.ix_(i, j)]


_LINES = (((0, -1), (0, 1)), ((-1, 0), (1, 0)),
          ((-1, -1), (1, 1)), ((-1, 1), (1, -1)))


def sup_inf(u):
    """Max over the four length-3 line erosions."""
    return np.maximum.reduce([
        np.minimum(np.minimum(shift(u, *a), shift(u, *b)), u)
        for a, b in _LINES])


def inf_sup(u):
    """Min over the four length-3 line dilations."""
    return np.minimum.reduce([
        np.maximum(np.maximum(shift(u, *a), shift(u, *b)), u)
        for a, b in _LINES])


def dilate8(u):
    return np.maximum.reduce([shift(u, di, dj)
                              for di in (-1, 0, 1) for dj in (-1, 0, 1)])


def erode8(u):
    return np.minimum.reduce([shift(u, di, dj)
                              for di in (-1, 0, 1) for dj in (-1, 0, 1)])


def smooth(u, k: int, smoothing: int):
    """``smoothing`` calls from call counter k: SIoIS on even calls,
    ISoSI on odd ones."""
    for c in range(k, k + smoothing):
        u = sup_inf(inf_sup(u)) if c % 2 == 0 else inf_sup(sup_inf(u))
    return u


def binary_means(img, u):
    w = u[..., None] if img.ndim == 3 else u
    c_in = (img * w).sum(axis=(0, 1)) / (u.sum() + 1e-8)
    c_out = (img * (1.0 - w)).sum(axis=(0, 1)) / ((1.0 - u).sum() + 1e-8)
    return c_in, c_out


def acwe_force(img, u, l1, l2):
    """Frozen ACWE data force from the current level set's means."""
    c_in, c_out = binary_means(img, u)
    f = l1 * (img - c_in) ** 2 - l2 * (img - c_out) ** 2
    return f.sum(-1) if img.ndim == 3 else f


def acwe_move(u, f):
    """Pixels with a nonzero discrete gradient move by the sign of f."""
    gx = shift(u, 1, 0) - shift(u, -1, 0)
    gy = shift(u, 0, 1) - shift(u, 0, -1)
    aux = (np.abs(gx) + np.abs(gy)) * f
    return np.where(aux < 0, 1.0, np.where(aux > 0, 0.0, u))


def morph_acwe(img, ls, iters, smoothing=1, l1=1.0, l2=1.0, k=1):
    """MorphACWE: force step then ``smoothing`` alternating cycles per
    iteration. ``k`` > 1 freezes the region means (and the force) for
    chunks of k iterations - the communication-avoiding sharded class;
    k = 1 is the published per-iteration scheme."""
    img = np.asarray(img, np.float64)
    u = np.asarray(ls, np.float64)
    l1 = np.asarray(l1, np.float64)
    l2 = np.asarray(l2, np.float64)
    f = None
    for n in range(iters):
        if n % k == 0:
            f = acwe_force(img, u, l1, l2)
        u = smooth(acwe_move(u, f), n * smoothing, smoothing)
    return u


def morph_gac(g, ls, iters, smoothing=1, balloon=0, threshold=0.5):
    """MorphGAC: balloon (full-3x3 dilate/erode where the edge map clears
    threshold/|balloon|), attraction (sign of grad g . grad u), then
    ``smoothing`` alternating cycles."""
    g = np.asarray(g, np.float64)
    u = np.asarray(ls, np.float64)
    dgx = 0.5 * (shift(g, 1, 0) - shift(g, -1, 0))
    dgy = 0.5 * (shift(g, 0, 1) - shift(g, 0, -1))
    mask = (g > threshold / abs(balloon)) if balloon else None
    for n in range(iters):
        if balloon > 0:
            u = np.where(mask, dilate8(u), u)
        elif balloon < 0:
            u = np.where(mask, erode8(u), u)
        dux = 0.5 * (shift(u, 1, 0) - shift(u, -1, 0))
        duy = 0.5 * (shift(u, 0, 1) - shift(u, 0, -1))
        aux = dgx * dux + dgy * duy
        u = np.where(aux > 0, 1.0, np.where(aux < 0, 0.0, u))
        u = smooth(u, n * smoothing, smoothing)
    return u
