"""Several GPUs: the grid's z slabs or its active-tile list sharded over
the ranks of a ``torch.distributed`` ``DeviceMesh``, one process and one
device a rank (counterpart of ``sdf_tpu.parallel``)."""

from .grid import make_mesh, mesh_and_march
from .multihost import gather_triangles, initialize, write_on_process0
from .sparse import mesh_sparse_tiles_sharded

__all__ = [
    "make_mesh",
    "mesh_and_march",
    "mesh_sparse_tiles_sharded",
    "initialize",
    "gather_triangles",
    "write_on_process0",
]
