"""Model zoo: the example workloads as importable functions, and the
fitting steps, on one device and sharded over a mesh's ranks (counterpart
of ``sdf_tpu.models``; ``models.fit`` holds ``fit``, ``fit_chamfer`` and
``make_chamfer_loss`` too, each with ``mesh=``)."""

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
from .fit import fit_step, make_sharded_fit_step

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
    "fit_step",
    "make_sharded_fit_step",
]
