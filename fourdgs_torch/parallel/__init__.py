"""Multi-device mapping on torch.distributed (port of fourdgs/parallel/):
the mesh (`make_mesh`), its collectives (`comm.Comm`) and the sharded
helpers (`sharded_map_step`, `batch_render_sharded`)."""

from fourdgs_torch.parallel.mesh import Mesh, MeshError, make_mesh  # noqa: F401
from fourdgs_torch.parallel.sharded import batch_render_sharded, sharded_map_step  # noqa: F401
