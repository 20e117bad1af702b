"""Model-level execution over a mesh, after ``pde_tpu/parallel/model.py``.

``pde_tpu`` runs a whole pyramid level under GSPMD: its inputs carry a
("ty", "tx") sharding and XLA places the collectives of every stencil,
warp and median. The port realises the same result this way: on a sharded
level the level's solver runs through the sharded solvers of
``parallel/tiled.py`` (its fields scattered to the mesh's tiles, relaxed
there with exchanged halos, and gathered back), while the data term, the
weights, the warp and the median run whole on the mesh's first device.
The sharded red-black solves equal the single-device ones bit for bit, so
a level gives the unsharded level's numbers.

Line-implicit levels (``solver=2``) run whole on the first device: their
full-image zebra lines cross the tiles, and so the result stays the
unsharded PCG's, as GSPMD's does (ROADMAP records it as a difference of
execution, not of result).

Multigrid coarse-level regather (``flow_fmg(..., mesh=...)``): a level is
sharded while ``min(H, W) >= shard_min`` and (H, W) divides over the mesh,
and runs whole on the first device below that, so tiny coarse grids do not
scatter 8-pixel tiles across devices.
"""

from __future__ import annotations

from functools import partial

from pde_tpu_torch.parallel.mesh import Mesh, shard, tile_sharding
from pde_tpu_torch.parallel.tiled import tiled_sor_flow_llin4


def shard_spec_for(mesh: Mesh, ndim: int):
    """(..., H, W) arrays: shard the trailing image plane over (ty, tx)."""
    return tile_sharding(mesh, ndim)


def _shards(shape, mesh: Mesh, shard_min: int) -> bool:
    h, w = shape[-2:]
    return (min(h, w) >= shard_min and h % mesh.shape["ty"] == 0
            and w % mesh.shape["tx"] == 0)


def place_level(x, mesh: Mesh | None, shard_min: int = 64):
    """``x`` as the mesh's ty x tx grid of tiles (``mesh.shard``) while its
    level is at least ``shard_min`` px and divides over the mesh, else
    whole on the mesh's first device (coarse pyramid levels)."""
    if mesh is None or x is None:
        return x
    if _shards(x.shape, mesh, shard_min):
        return shard(x, mesh)
    return x.to(mesh.device)


def constrain_level(x, mesh: Mesh | None, shard_min: int = 64):
    """Inside ``flow_fmg``: the mesh that the solves of ``x``'s level run
    over, by ``place_level``'s rule; None (the level's solves run whole on
    the mesh's first device) below ``shard_min`` or where the level does not
    divide over the mesh."""
    if mesh is None or not _shards(x.shape, mesh, shard_min):
        return None
    return mesh


def sharded_nd_level(mesh: Mesh, u, v, i1t0, i1t1, i2t0, i2t1,
                     us_ap, vs_ap, as_diff, p, snd_is_gradmag: bool):
    """One full ``flow_nd`` pyramid level over the mesh. Arguments mirror
    ``models.flow_nd._nd_level``; the (H, W) and (C, H, W) inputs are
    taken to the mesh's first device, where the level runs with its SOR
    solves sharded (``tiled_sor_flow_llin4``). Returns (U, V) whole on the
    first device."""
    from pde_tpu_torch.models.flow_nd import _nd_level

    args = [None if x is None else x.to(mesh.device)
            for x in (u, v, i1t0, i1t1, i2t0, i2t1, us_ap, vs_ap)]
    return _nd_level(args[0], args[1], None, *args[2:], as_diff, p, snd_is_gradmag,
                     sor=partial(tiled_sor_flow_llin4, mesh))


def mesh_nd_level(u, v, it0, i1t0, i1t1, i2t0, i2t1, us_ap, vs_ap, as_diff, p,
                  snd_is_gradmag: bool, *, mesh: Mesh, shard_min: int):
    """``flow_nd``'s level function over a mesh: ``sharded_nd_level`` for a
    level ``place_level`` would shard, else the level whole on the mesh's
    first device."""
    if _shards(u.shape, mesh, shard_min):
        return sharded_nd_level(mesh, u, v, i1t0, i1t1, i2t0, i2t1, us_ap, vs_ap, as_diff, p,
                                snd_is_gradmag)
    from pde_tpu_torch.models.flow_nd import _nd_level

    return _nd_level(u, v, it0, i1t0, i1t1, i2t0, i2t1, us_ap, vs_ap, as_diff, p,
                     snd_is_gradmag)
