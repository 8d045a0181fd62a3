"""chan_vese: Chan-Vese active-contour segmentation in JAX.

A ground-up JAX/XLA re-design (not a port) of the capabilities of the
C++ reference ``ktht/chan_vese`` (see SURVEY.md; the reference checkout was
empty at build time, so the published scheme pinned by BASELINE.json is the
spec): scalar, vector-valued (RGB) and multiphase (Vese-Chan) energies, a
semi-implicit red-black Gauss-Seidel solver compiled by XLA, vmap-batched
stacks, and a 2D-sharded grid with collective halo exchange.
"""

from .params import CVParams, DEFAULTS
from .models.scalar import SegResult, SegTrace, segment, segment_fixed, step
from .models.vector import segment_vector, segment_vector_fixed
from .models.multiphase import (MultiphaseResult, segment_multiphase,
                                segment_multiphase_fixed)
from .models.batched import segment_batch, segment_stack_fixed
from .models.morph import (segment_morph, segment_morph_fixed,
                           segment_morph_sharded)
from .models.morph_gac import (segment_gac, segment_gac_fixed,
                               segment_gac_sharded)
from .compat import (chan_vese, checkerboard_level_set, disk_level_set,
                     inverse_gaussian_gradient, morphological_chan_vese,
                     morphological_geodesic_active_contour)

__all__ = [
    "chan_vese", "morphological_chan_vese",
    "morphological_geodesic_active_contour", "inverse_gaussian_gradient",
    "checkerboard_level_set", "disk_level_set",
    "segment_morph", "segment_morph_fixed", "segment_morph_sharded",
    "segment_gac", "segment_gac_fixed", "segment_gac_sharded",
    "CVParams", "DEFAULTS",
    "segment", "segment_fixed", "step", "SegResult", "SegTrace",
    "segment_vector", "segment_vector_fixed",
    "segment_multiphase", "segment_multiphase_fixed", "MultiphaseResult",
    "segment_batch", "segment_stack_fixed",
]

__version__ = "0.1.0"
