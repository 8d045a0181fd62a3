"""Numerics: the L0-L2 layers (SURVEY.md §1) as plain jnp compiled by XLA."""

from .numerics import (curvature, dirac, face_coeffs, face_coeffs_all,
                       face_coeffs_backward, grad_central, grad_forward,
                       heaviside, neumann_pad)
from .reductions import (data_term, delta_norm, energy, means_from_sums,
                         region_means, region_sums)
from .sweep import (color_masks, jacobi_step, redblack_step,
                    semi_implicit_step, wavefront_step)
from .reinit import reinit
from .diffusion import perona_malik

__all__ = [
    "heaviside", "dirac", "curvature", "face_coeffs", "face_coeffs_all",
    "face_coeffs_backward", "grad_forward", "grad_central", "neumann_pad",
    "region_means", "region_sums", "means_from_sums", "data_term",
    "energy", "delta_norm",
    "semi_implicit_step", "redblack_step", "jacobi_step", "wavefront_step",
    "color_masks", "reinit", "perona_malik",
]
