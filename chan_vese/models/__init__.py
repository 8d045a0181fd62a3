"""Model families: scalar, vector-valued (RGB), multiphase, batched,
pyramid and morphological."""

from .scalar import SegResult, SegTrace, segment, segment_fixed, step
from .vector import segment_vector, segment_vector_fixed
from .multiphase import (MultiphaseResult, MultiphaseTrace,
                         segment_multiphase, segment_multiphase_fixed)
from .batched import segment_batch, segment_stack_fixed
from .pyramid import (MultiphasePyramidResult, PyramidResult,
                      segment_pyramid, segment_pyramid_multiphase,
                      segment_pyramid_sharded)
from .morph import (MorphResult, MorphTrace, segment_morph,
                    segment_morph_fixed, segment_morph_iterations,
                    segment_morph_sharded)

__all__ = [
    "segment", "segment_fixed", "step", "SegResult", "SegTrace",
    "segment_vector", "segment_vector_fixed",
    "segment_multiphase", "segment_multiphase_fixed",
    "MultiphaseResult", "MultiphaseTrace",
    "segment_batch", "segment_stack_fixed",
    "segment_pyramid", "PyramidResult",
    "segment_pyramid_multiphase", "MultiphasePyramidResult",
    "segment_pyramid_sharded",
    "segment_morph", "segment_morph_fixed", "segment_morph_sharded",
    "segment_morph_iterations",
    "MorphResult", "MorphTrace",
]
