"""Parameter set for Chan–Vese segmentation.

Mirrors the C++ reference's parameter surface (SURVEY.md C15, BASELINE.json
north star: "matching the C++ reference's API, parameters (mu, nu, lambda1/2,
dt, eps) and per-pixel tolerance"). The reference checkout was empty at build
time (SURVEY.md §0), so names/defaults follow the canonical published scheme
(Chan & Vese 2001; Getreuer, IPOL 2012) that BASELINE.json pins.

``CVParams`` is a frozen (hashable) dataclass and is passed as a *static*
argument into jitted entry points: every field is a Python float/int/str, so
changing a parameter triggers a recompile (the common case is many images,
one parameter set).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CVParams:
    """Chan–Vese model + solver parameters.

    Operating point / normalization convention (load-bearing, SURVEY.md §7
    "hard parts"): intensities are expected in **[0, 255]** with lambda1 =
    lambda2 = 1 and mu of order 0.01-0.25 times 255^2 - the scaling of the
    original Chan-Vese 2001 experiments (mu = 0.01 * 255^2 for multi-object
    images). At this scale the data force is O(10^4): phi grows to O(100)
    within a few iterations, H_eps(phi) sharpens into an indicator, the
    region means lock onto the true region intensities and the contour
    moves fast (convergence in tens of iterations). Running [0, 1] images
    with unscaled mu slows the dynamics by ~255^2 (verified empirically in
    tests/test_scalar.py::test_normalization_scaling_matters) - if your
    image is in [0, 1], multiply it by 255 or scale mu/nu by (1/255)^2.

    Attributes:
      mu: weight of the contour-length penalty (curvature term).
      nu: weight of the inside-area penalty.
      lambda1: weight of the inside data-fitting term (u0 - c1)^2.
      lambda2: weight of the outside data-fitting term (u0 - c2)^2.
      dt: time step of the semi-implicit update (unconditionally stable).
      eps: regularization width of the Heaviside/Dirac (H_eps, delta_eps).
      tol: per-pixel convergence tolerance on the update metric: with the
        default conv_norm='flips' it is the fraction of pixels whose mask
        sign may still change per iteration (converged when below); with
        'rms'/'mean_abs' it is the classic per-pixel delta-phi tolerance.
      max_iter: iteration cap.
      min_iter: never declare convergence before this many iterations.
      patience: the update metric must stay below tol for this many
        CONSECUTIVE iterations - guards against the near-symmetric start,
        where c1 ~ c2 makes the data force (and hence flips) vanish for an
        iteration or two before the dynamics pick up.
      eta2: curvature-denominator regularizer eta^2 inside the sqrt,
        |grad phi| ~ sqrt(eta2 + ...). Keeps 1/|grad phi| finite on flats.
      conv_norm: 'flips' (fraction of mask sign changes; scale-invariant
        default), 'rms' (sqrt(mean(dphi^2))), or 'mean_abs' (mean(|dphi|)).
      reinit_every: if > 0, redistance phi (Sussman PDE, ops/reinit.py)
        every K iterations - keeps |grad phi| ~ 1 when running long
        evolutions (optional in the reference lineage, SURVEY.md C11).
      reinit_steps: upwind redistancing steps per reinit call.
      order: sweep ordering of the semi-implicit solve:
        'redblack'  - two vectorized half-sweeps (the fast path; same fixed
                      point as raster Gauss-Seidel),
        'jacobi'    - fully parallel update from old values,
        'wavefront' - skewed-diagonal schedule that reproduces sequential
                      raster Gauss-Seidel EXACTLY (parity mode; slow).
      init: level-set initialization: 'checkerboard' | 'circle' (alias
        'disk') | 'small disk' | 'rect'.
    """

    mu: float = 0.01 * 255.0 ** 2  # canonical length weight for [0,255] images
    nu: float = 0.0
    lambda1: float = 1.0
    lambda2: float = 1.0
    dt: float = 0.5
    eps: float = 1.0
    tol: float = 1e-5
    max_iter: int = 500
    eta2: float = 1e-8
    conv_norm: str = "flips"
    min_iter: int = 5
    patience: int = 3
    order: str = "redblack"
    init: str = "checkerboard"
    reinit_every: int = 0
    reinit_steps: int = 20

    def replace(self, **kw) -> "CVParams":
        return dataclasses.replace(self, **kw)

    def channel_lambdas(self, nchan: int,
                        lambda1: Optional[Tuple[float, ...]] = None,
                        lambda2: Optional[Tuple[float, ...]] = None,
                        ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        """Per-channel lambda weights for the vector-valued energy.

        Falls back to broadcasting the scalar lambda1/lambda2 when no
        per-channel weights are given (Chan-Sandberg-Vese 2000).
        """
        def norm(lam, default):
            if lam is None:
                return (default,) * nchan
            try:
                return tuple(float(v) for v in lam)
            except TypeError:  # scalar: broadcast like the jnp reductions
                return (float(lam),) * nchan

        l1 = norm(lambda1, self.lambda1)
        l2 = norm(lambda2, self.lambda2)
        # a length-1 tuple is a scalar in sequence clothing (the CLI's
        # default --lambda1 is [1.0] regardless of channel count)
        if len(l1) == 1 and nchan > 1:
            l1 = l1 * nchan
        if len(l2) == 1 and nchan > 1:
            l2 = l2 * nchan
        if len(l1) != nchan or len(l2) != nchan:
            raise ValueError(
                f"per-channel lambdas must have length {nchan}, "
                f"got {len(l1)} / {len(l2)}")
        return l1, l2


DEFAULTS = CVParams()
