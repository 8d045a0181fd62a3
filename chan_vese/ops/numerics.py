"""Numerics primitives: regularized Heaviside/Dirac, stencils, curvature.

Design notes:
  * Everything here is shape-polymorphic, dtype-preserving, pure jnp - it
    traces once under jit and fuses into neighboring ops.
  * Neumann boundary conditions are realized as *clamped-index* (edge
    replicate) semantics, matching the canonical C scheme's
    ``reflect(i, n)`` index clamp (SURVEY.md C1). On arrays we express the
    clamp as shift-with-edge-hold, which XLA lowers to cheap slices/pads
    (no gathers).

Reference parity: formulas follow Chan & Vese 2001 ("H_2/delta_2"
regularization, §3) and the discretization in SURVEY.md §3.1. The C++
reference mount was empty (SURVEY.md §0); the published scheme is the spec.
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def heaviside(z, eps: float):
    """Regularized Heaviside H_eps(z) = 1/2 (1 + (2/pi) atan(z/eps)).

    SURVEY.md C2. Smooth, nonzero everywhere -> every pixel contributes to
    both region means (the 'global' Chan-Vese behavior).
    """
    return 0.5 * (1.0 + (2.0 / math.pi) * jnp.arctan(z / eps))


def dirac(z, eps: float):
    """Regularized Dirac delta_eps(z) = (1/pi) eps / (eps^2 + z^2).

    SURVEY.md C2; delta_eps = d/dz H_eps (verified in tests against
    jax.grad).
    """
    return (eps / math.pi) / (eps * eps + z * z)


# ---------------------------------------------------------------------------
# Clamped-index (edge-replicate / Neumann) neighbor shifts.
#
# shift_*(x)[i, j] == x[clamp(i +/- 1), clamp(j +/- 1)] - i.e. the value of
# the neighbor in that direction under clamped indexing. Implemented with
# static slices + edge repeat so XLA emits pure data movement.
# ---------------------------------------------------------------------------

def shift_up(x):
    """y[i, j] = x[max(i - 1, 0), j]  (value of the north neighbor)."""
    return jnp.concatenate([x[:1], x[:-1]], axis=0)


def shift_down(x):
    """y[i, j] = x[min(i + 1, H - 1), j]  (south neighbor)."""
    return jnp.concatenate([x[1:], x[-1:]], axis=0)


def shift_left(x):
    """y[i, j] = x[i, max(j - 1, 0)]  (west neighbor)."""
    return jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)


def shift_right(x):
    """y[i, j] = x[i, min(j + 1, W - 1)]  (east neighbor)."""
    return jnp.concatenate([x[:, 1:], x[:, -1:]], axis=1)


def neumann_pad(x, depth: int = 1):
    """Edge-replicate pad by ``depth`` on both spatial axes."""
    return jnp.pad(x, ((depth, depth), (depth, depth)), mode="edge")


def grad_forward(phi):
    """Forward differences (D+x, D+y) with clamped last row/col (=> 0 there)."""
    gx = shift_down(phi) - phi   # along rows (i direction)
    gy = shift_right(phi) - phi  # along cols (j direction)
    return gx, gy


def grad_central(phi):
    """Central differences with clamped-index boundary handling."""
    gx = 0.5 * (shift_down(phi) - shift_up(phi))
    gy = 0.5 * (shift_right(phi) - shift_left(phi))
    return gx, gy


def curvature(phi, eta2: float):
    """Finite-difference curvature kappa = div(grad phi / |grad phi|).

    Divergence-form 9-point discretization (SURVEY.md C4), written in the
    same linearized neighbor-coefficient form the semi-implicit sweep uses:

        kappa[i,j] =   A[i,j]   (phi[i+1,j] - phi[i,j])
                     + A[i-1,j] (phi[i-1,j] - phi[i,j])
                     + B[i,j]   (phi[i,j+1] - phi[i,j])
                     + B[i,j-1] (phi[i,j-1] - phi[i,j])

    with clamped neighbor *values*, so boundary fluxes vanish automatically
    (phi[clamp(-1)] - phi[0] == 0 -> zero-flux Neumann), and clamped
    coefficient indices (harmless: multiplied by the vanishing difference).
    """
    A, B, Am, Bm = face_coeffs_all(phi, 1.0, eta2)
    return (A * (shift_down(phi) - phi)
            + Am * (shift_up(phi) - phi)
            + B * (shift_right(phi) - phi)
            + Bm * (shift_left(phi) - phi))


def face_coeffs(phi, mu: float, eta2: float):
    """Forward half-point curvature coefficients of the scheme.

    SURVEY.md §3.1:
        A[i,j] = mu / sqrt(eta2 + (phi[i+1,j]-phi[i,j])^2
                                + ((phi[i,j+1]-phi[i,j-1])/2)^2)
        B[i,j] = mu / sqrt(eta2 + ((phi[i+1,j]-phi[i-1,j])/2)^2
                                + (phi[i,j+1]-phi[i,j])^2)

    A lives on the (i+1/2, j) face (couples phi[i,j] <-> phi[i+1,j]);
    B on the (i, j+1/2) face. Boundary convention is *replica-eval*
    (Getreuer IPOL 2012 / pad-then-compute lineage): every out-of-range
    VALUE read clamps to the edge, so out-of-range differences vanish.
    See :func:`face_coeffs_backward` for A-, B-.
    """
    dxp = shift_down(phi) - phi                      # phi[i+1,j] - phi[i,j]
    dyp = shift_right(phi) - phi                     # phi[i,j+1] - phi[i,j]
    dx0 = 0.5 * (shift_down(phi) - shift_up(phi))    # central in i
    dy0 = 0.5 * (shift_right(phi) - shift_left(phi))  # central in j
    A = mu / jnp.sqrt(eta2 + dxp * dxp + dy0 * dy0)
    B = mu / jnp.sqrt(eta2 + dx0 * dx0 + dyp * dyp)
    return A, B


def face_coeffs_backward(phi, mu: float, eta2: float):
    """Backward coefficients A-[i,j] (= A at face (i-1/2, j)) and B-.

    Replica-eval convention: A- is the A formula evaluated at (i-1, j)
    with clamped VALUE reads - for i >= 1 this is exactly A[i-1, j]; at
    i = 0 the forward difference vanishes (phi[0]-phi[-1->0] = 0) and the
    central term is row 0's, i.e. the formula computed on an edge-padded
    array. This is the convention that makes spatial sharding exact:
    replica halos at global edges ARE the padded array
    (parallel/sharded.py).
    """
    _, _, Am, Bm = face_coeffs_all(phi, mu, eta2)
    return Am, Bm


def face_coeffs_all(phi, mu: float, eta2: float):
    """All four face coefficients, reusing the forward fields.

    Away from the boundary A-[i] == A[i-1] exactly (dxm[i] == dxp[i-1],
    shifted dy0), so A-/B- are shifts of A/B with a one-row/col boundary
    fix (the replica-eval value with the vanishing forward difference) -
    two sqrt evaluations instead of four, bitwise-identical results.
    """
    dxp = shift_down(phi) - phi
    dyp = shift_right(phi) - phi
    dx0 = 0.5 * (shift_down(phi) - shift_up(phi))
    dy0 = 0.5 * (shift_right(phi) - shift_left(phi))
    A = mu / jnp.sqrt(eta2 + dxp * dxp + dy0 * dy0)
    B = mu / jnp.sqrt(eta2 + dx0 * dx0 + dyp * dyp)
    am0 = mu / jnp.sqrt(eta2 + dy0[:1] * dy0[:1])
    Am = jnp.concatenate([am0, A[:-1]], axis=0)
    bm0 = mu / jnp.sqrt(eta2 + dx0[:, :1] * dx0[:, :1])
    Bm = jnp.concatenate([bm0, B[:, :-1]], axis=1)
    return A, B, Am, Bm
