"""Morphological Chan-Vese (MorphACWE) operators (rebuild-side capability).

Curvature regularization as alternating morphological sup-inf / inf-sup
operators over a BINARY level set, per the published MorphACWE scheme
(Marquez-Neila, Baumela, Alvarez, PAMI 2014) - the algorithm scikit-image
ships as ``morphological_chan_vese``. The reference mount is empty
(SURVEY.md Section 0) and SURVEY's component inventory covers only the
PDE lineage, so this module is a rebuild-side extension completing the
compat surface: ``compat.chan_vese`` mirrors skimage's ``chan_vese``;
``compat.morphological_chan_vese`` (models/morph.py) mirrors its sibling.

Structure: the level set is a float plane of {0.0, 1.0} and every
operator below is neighbor-shift + min/max arithmetic - no gather, no
masks, no data-dependent control flow - so XLA fuses a full smoothing
cycle into a few elementwise passes and the whole iteration (means -> discrete force -> smoothing) jits into one
device program. The binary state also makes the iteration bitwise
reproducible across backends (all comparisons and min/max are exact),
which the CPU-golden equivalence tests exploit.

Edge convention: the framework-wide replica-eval Neumann semantics
(ops/numerics shift_*: out-of-range neighbors repeat the edge pixel).
NOTE this deliberately differs from scipy.ndimage.binary_erosion's
default border_value=0 (which erodes a one-pixel frame every SI pass,
and is what skimage's implementation inherits); interior behavior is
identical, and the replica convention is the one every other operator
in this framework pins (CLAUDE.md numerics invariants).

The four length-3 line structuring elements of the scheme (horizontal,
vertical, both diagonals) become: erosion along a line = min(center,
the two opposite neighbors); dilation = max. sup_inf = max over the four
line erosions (removes structures thinner than the lines without moving
straight edges); inf_sup is the dual. Alternating the composition
SIoIS / ISoSI per smoothing call (cycle_op) cancels the systematic
shrink/grow bias of either composition alone - the published scheme's
operator cycling, realized here with a traced call counter + lax.cond
so the alternation lives inside one compiled program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .numerics import shift_down, shift_left, shift_right, shift_up


def _neighbors8(u):
    """The 8 replica-clamped neighbor planes of u.

    Diagonals compose two axis shifts; replica clamping composes
    correctly (corner out-of-range pixels repeat the corner).
    """
    up, dn = shift_up(u), shift_down(u)
    lf, rt = shift_left(u), shift_right(u)
    ul, ur = shift_left(up), shift_right(up)
    dl, dr = shift_left(dn), shift_right(dn)
    return up, dn, lf, rt, ul, ur, dl, dr


def sup_inf(u):
    """max over the 4 line SEs of the erosion (min) along that line."""
    up, dn, lf, rt, ul, ur, dl, dr = _neighbors8(u)
    e_h = jnp.minimum(jnp.minimum(lf, rt), u)
    e_v = jnp.minimum(jnp.minimum(up, dn), u)
    e_d = jnp.minimum(jnp.minimum(ul, dr), u)   # main diagonal
    e_a = jnp.minimum(jnp.minimum(ur, dl), u)   # anti-diagonal
    return jnp.maximum(jnp.maximum(e_h, e_v), jnp.maximum(e_d, e_a))


def inf_sup(u):
    """min over the 4 line SEs of the dilation (max) along that line."""
    up, dn, lf, rt, ul, ur, dl, dr = _neighbors8(u)
    d_h = jnp.maximum(jnp.maximum(lf, rt), u)
    d_v = jnp.maximum(jnp.maximum(up, dn), u)
    d_d = jnp.maximum(jnp.maximum(ul, dr), u)
    d_a = jnp.maximum(jnp.maximum(ur, dl), u)
    return jnp.minimum(jnp.minimum(d_h, d_v), jnp.minimum(d_d, d_a))


def cycle_op(u, k):
    """One smoothing call: SIoIS when the call counter k is even, ISoSI
    when odd (the scheme's global operator cycling). k is traced, so the
    branch is a lax.cond inside the compiled program."""
    return jax.lax.cond(k % 2 == 0,
                        lambda v: sup_inf(inf_sup(v)),
                        lambda v: inf_sup(sup_inf(v)),
                        u)


def smooth(u, k, smoothing: int):
    """``smoothing`` consecutive cycle_op calls, counter advancing by one
    per call (matching a per-call global counter: iteration n with
    smoothing s starts at k = n*s)."""
    for i in range(smoothing):
        u = cycle_op(u, k + i)
    return u


def binary_means(img, u, tiny: float = 1e-8):
    """Region means of ``img`` inside (u==1) and outside (u==0).

    img: (H, W) or (H, W, C); returns scalars or (C,) vectors. The
    ``tiny`` guard keeps an empty region finite (mean -> 0) instead of
    NaN-poisoning the run - an empty region's force then pushes pixels
    back toward it only if the data supports it.
    """
    w = u[..., None] if img.ndim == 3 else u
    axes = (0, 1)
    n_in = jnp.sum(u)
    n_out = jnp.sum(1.0 - u)
    c_in = jnp.sum(img * w, axis=axes) / (n_in + tiny)
    c_out = jnp.sum(img * (1.0 - w), axis=axes) / (n_out + tiny)
    return c_in, c_out


def acwe_step(u, img, c_in, c_out, lambda1, lambda2):
    """The discrete ACWE data-force step.

    f = lambda1*(img-c_in)^2 - lambda2*(img-c_out)^2 (summed over
    channels for (H, W, C) images); pixels where the level set has a
    nonzero discrete gradient move by sign(f): f < 0 -> inside (1),
    f > 0 -> outside (0), f == 0 or flat-gradient pixels keep their
    value. Gradient = central differences with replica edges; only the
    ZERO/nonzero distinction matters (the force is multiplied by
    |grad u| in the published scheme, and u is updated by the SIGN of
    that product), so the replica-vs-one-sided edge scaling difference
    vs np.gradient is immaterial.
    """
    f = lambda1 * (img - c_in) ** 2 - lambda2 * (img - c_out) ** 2
    if img.ndim == 3:
        f = jnp.sum(f, axis=-1)
    gx = shift_down(u) - shift_up(u)
    gy = shift_right(u) - shift_left(u)
    abs_du = jnp.abs(gx) + jnp.abs(gy)
    aux = abs_du * f
    one = jnp.ones((), u.dtype)
    zero = jnp.zeros((), u.dtype)
    return jnp.where(aux < 0, one, jnp.where(aux > 0, zero, u))


def acwe_energy(img, u, c_in, c_out, lambda1, lambda2):
    """Piecewise-constant ACWE data energy (no length term - the
    morphological smoothing is not a gradient flow of any explicit
    length functional; this traces the data-fit part only)."""
    e = lambda1 * (img - c_in) ** 2 * (u[..., None] if img.ndim == 3
                                       else u)
    e2 = lambda2 * (img - c_out) ** 2 * ((1.0 - u)[..., None]
                                         if img.ndim == 3 else (1.0 - u))
    return jnp.sum(e) + jnp.sum(e2)


# ---------------------------------------------------------------------------
# MorphGAC (morphological geodesic active contours) operators
# ---------------------------------------------------------------------------

def gaussian_blur(img, sigma: float, truncate: float = 4.0):
    """Separable Gaussian blur with replica (edge) boundary handling.

    Kernel = the discretized Gaussian scipy.ndimage uses (exp(-x^2 /
    (2 sigma^2)) over x in [-r, r], r = int(truncate*sigma + 0.5),
    normalized to sum 1), applied per axis as a weighted sum of slices
    of an edge-padded plane. sigma/truncate are trace-time constants, so
    the whole blur unrolls into 2(2r+1) fused multiply-adds - no gather,
    no conv op needed, and the replica pad matches scipy's
    mode='nearest' exactly (tests pin this against scipy). Works on
    (H, W) planes; vmap/loop per channel for multichannel."""
    sigma = float(sigma)
    if sigma <= 0:
        return img
    r = int(truncate * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w = (w / w.sum()).astype(np.float64)
    H, W = img.shape
    pad = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    out = sum(jnp.asarray(w[d + r], img.dtype) * pad[d + r:d + r + H]
              for d in range(-r, r + 1))
    pad = jnp.pad(out, ((0, 0), (r, r)), mode="edge")
    return sum(jnp.asarray(w[d + r], img.dtype) * pad[:, d + r:d + r + W]
               for d in range(-r, r + 1))


def inverse_gaussian_gradient(img, alpha: float = 100.0,
                              sigma: float = 5.0):
    """Edge-stopping map g = 1/sqrt(1 + alpha*|grad(G_sigma * img)|).

    The MorphGAC preprocessor (the function scikit-image ships under the
    same name): close to 1 in flat regions, close to 0 on strong edges.
    Gradient = central differences of the blurred plane with replica
    edges (vs scipy's derivative-of-Gaussian filters - same scale, the
    framework's one convention; compat docstring notes the difference).
    (H, W, C) images take the per-channel blurred gradients' root sum of
    squares, so any channel's edge stops the contour."""
    if img.ndim == 3:
        mag2 = 0.0
        for c in range(img.shape[-1]):
            s = gaussian_blur(img[..., c], sigma)
            gx = 0.5 * (shift_down(s) - shift_up(s))
            gy = 0.5 * (shift_right(s) - shift_left(s))
            mag2 = mag2 + gx * gx + gy * gy
    else:
        s = gaussian_blur(img, sigma)
        gx = 0.5 * (shift_down(s) - shift_up(s))
        gy = 0.5 * (shift_right(s) - shift_left(s))
        mag2 = gx * gx + gy * gy
    return 1.0 / jnp.sqrt(1.0 + alpha * jnp.sqrt(mag2))


def dilate8(u):
    """Binary dilation by the full 3x3 structuring element (max over the
    pixel and its 8 replica-clamped neighbors) - the balloon-force
    structure of the published MorphGAC scheme."""
    up, dn, lf, rt, ul, ur, dl, dr = _neighbors8(u)
    m = jnp.maximum
    return m(m(m(up, dn), m(lf, rt)), m(m(ul, ur), m(m(dl, dr), u)))


def erode8(u):
    """Binary erosion by the full 3x3 structuring element (min dual)."""
    up, dn, lf, rt, ul, ur, dl, dr = _neighbors8(u)
    m = jnp.minimum
    return m(m(m(up, dn), m(lf, rt)), m(m(ul, ur), m(m(dl, dr), u)))


def gac_step(u, dgx, dgy, balloon_mask, balloon: int):
    """One MorphGAC force iteration (balloon + attraction), no smoothing.

    balloon is a STATIC sign (+1 grow / -1 shrink / 0 off): the balloon
    term dilates (grows) or erodes (shrinks) the binary region, applied
    only where ``balloon_mask`` is 1 (pixels whose edge map is above
    threshold/|balloon| - far from edges, where the attraction force has
    nothing to act on). The attraction term moves contour pixels along
    the edge map's gradient: aux = dg . du (central differences, replica
    edges); aux > 0 -> inside, aux < 0 -> outside, ties keep their
    value. Smoothing (the shared cycle_op) is applied by the drivers."""
    if balloon > 0:
        u = jnp.where(balloon_mask > 0, dilate8(u), u)
    elif balloon < 0:
        u = jnp.where(balloon_mask > 0, erode8(u), u)
    dux = 0.5 * (shift_down(u) - shift_up(u))
    duy = 0.5 * (shift_right(u) - shift_left(u))
    aux = dgx * dux + dgy * duy
    one = jnp.ones((), u.dtype)
    zero = jnp.zeros((), u.dtype)
    return jnp.where(aux > 0, one, jnp.where(aux < 0, zero, u))
