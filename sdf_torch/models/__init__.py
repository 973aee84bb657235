"""Model zoo: the example workloads as importable functions (counterpart
of ``sdf_tpu.models``; the fitting helpers of that package wait for the
differentiable path, ROADMAP A12)."""

from .zoo import (
    MODELS,
    blobby,
    customizable_box_body,
    customizable_box_lid,
    example,
    gearlike,
    knurling,
    pawn,
    saddle,
    weave,
)

__all__ = [
    "MODELS",
    "example",
    "blobby",
    "gearlike",
    "knurling",
    "pawn",
    "weave",
    "customizable_box_body",
    "customizable_box_lid",
    "saddle",
]
