"""Spatial parallelism over a ("ty", "tx") mesh of devices, after
``pde_tpu/parallel``: mesh construction (``mesh.py``), halo exchange
between tiles (``halo.py``), the sharded solvers (``tiled.py``) and the
model levels over a mesh (``model.py``; ``flow_nd`` and ``flow_fmg`` take
``mesh=``/``shard_min=``).

``pde_tpu`` shards the image plane over a ``jax.sharding.Mesh`` from one
controller. The port does the same from one process: a ``Mesh`` is a grid
of ``torch.device``s, a field is a grid of tiles on them, and halo strips
move between devices by copy. A device may repeat in the grid (a virtual
mesh), so one card, several cards and the CPU run the same code.
"""

from pde_tpu_torch.parallel.mesh import make_mesh, tile_sharding  # noqa: F401
from pde_tpu_torch.parallel.halo import halo_exchange  # noqa: F401
