"""Device meshes and the split of (..., H, W) fields into tiles, after
``pde_tpu/parallel/mesh.py``.

A ``Mesh`` is a ``ty`` x ``tx`` grid of ``torch.device``s: tile-rows and
tile-cols of the image plane, the axes ``("ty", "tx")``. One process drives
it, as one JAX controller drives a ``jax.sharding.Mesh``: a field is cut
into a grid of tiles, each a tensor on its device (``shard``), and put back
together on one device (``unshard``). A device may repeat in the grid (a
virtual mesh, as JAX's CPU mesh of host devices), so the same code runs on
one card, on several, and on the CPU. A mesh is all CUDA or all CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Mesh:
    """A ``ty`` x ``tx`` grid of devices; ``devices[i][j]`` holds the tile
    of tile-row i and tile-col j."""

    def __init__(self, devices):
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not self.devices or not self.devices[0] \
                or any(len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        types = {d.type for row in self.devices for d in row}
        if types not in ({"cpu"}, {"cuda"}):
            raise ValueError(f"a mesh's devices are all CUDA or all CPU, got {sorted(types)}")

    @property
    def shape(self) -> dict:
        return {"ty": len(self.devices), "tx": len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The first device: where a model over the mesh keeps its whole
        fields, and the CG scalars of ``tiled_pcg_flow_llin4``."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def make_mesh(ty: int = 1, tx: int | None = None, devices=None) -> Mesh:
    """Build a (ty, tx) mesh over ``devices``: by default the CUDA cards,
    each once. ``tx`` defaults to the devices left over ty rows. An explicit
    list may repeat a device (a virtual mesh). Raises when ``ty * tx``
    exceeds the devices given."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if tx is None:
        tx = len(devices) // ty
    n = ty * tx
    if ty < 1 or tx < 1 or n > len(devices):
        raise ValueError(f"mesh {ty}x{tx} needs {max(n, 1)} devices, have {len(devices)}")
    return Mesh([devices[i * tx:(i + 1) * tx] for i in range(ty)])


def field_spec(ndim: int = 2) -> tuple:
    """The split of an ndim field: its trailing (H, W) over ("ty", "tx"),
    the leading dims whole (``pde_tpu``'s ``PartitionSpec``)."""
    return (None,) * (ndim - 2) + ("ty", "tx")


class TileSharding(NamedTuple):
    """A field split over ``mesh`` as ``spec`` says (``pde_tpu``'s
    ``NamedSharding``)."""

    mesh: Mesh
    spec: tuple


def tile_sharding(mesh: Mesh, ndim: int = 2) -> TileSharding:
    """Sharding that splits the trailing (H, W) dims over (ty, tx)."""
    return TileSharding(mesh, field_spec(ndim))


def mesh_device(mesh: Mesh, x=None, device=None) -> torch.device:
    """Where an entry point given ``mesh`` runs: the mesh's first device.
    Raises when ``device`` or the tensor ``x`` asks for another kind of
    device (a CUDA mesh never computes on the CPU, nor a CPU mesh on a
    card)."""
    kind = mesh.device.type
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f"device={device!r} with a mesh of {kind} devices")
    if torch.is_tensor(x) and x.device.type != kind:
        raise ValueError(f"an input on {x.device} with a mesh of {kind} devices")
    return mesh.device


def shard(x: torch.Tensor, mesh: Mesh):
    """``x`` (..., H, W) as a ty x tx grid (a list of rows) of contiguous
    (..., H/ty, W/tx) tiles, each on its mesh device. Raises when H or W
    does not divide over the mesh."""
    nty, ntx = mesh.shape["ty"], mesh.shape["tx"]
    gh, gw = x.shape[-2:]
    if gh % nty or gw % ntx:
        raise ValueError(f"a {gh}x{gw} field does not divide over a {nty}x{ntx} mesh")
    h, w = gh // nty, gw // ntx
    return [[x[..., i * h:(i + 1) * h, j * w:(j + 1) * w].to(mesh.devices[i][j]).contiguous()
             for j in range(ntx)] for i in range(nty)]


def unshard(tiles, device) -> torch.Tensor:
    """The grid of ``shard`` (or of any equal-shaped tiles) as one field on
    ``device``."""
    return torch.cat([torch.cat([t.to(device) for t in row], dim=-1) for row in tiles], dim=-2)
