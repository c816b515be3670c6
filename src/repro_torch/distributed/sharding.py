"""Logical-axis -> mesh-axis rules, and their ``DTensor`` placements.

The JAX package names each tensor axis logically (``"batch"``, ``"vol_x"``,
...) and maps the names onto mesh axes with one rule set per workload
(``repro.distributed.sharding``).  The registration rules are ported here;
a rule's ``PartitionSpec`` becomes a tuple of ``DTensor`` placements, one a
mesh dimension: ``Shard(i)`` where tensor dimension ``i`` maps onto that
mesh dimension, ``Replicate()`` where none does.  The LM rules (train,
decode, long context) belong to the LM's sharded serving, not ported yet
(ROADMAP.md queue 1 item 17d).
"""

from __future__ import annotations

__all__ = ["AxisRules", "REGISTRATION_RULES", "placements"]


class AxisRules(dict):
    """logical axis name -> mesh axis (str | tuple | None)."""

    def spec(self, axes) -> tuple:
        """The mesh axes of each logical axis in ``axes`` (a PartitionSpec's
        entries)."""
        return tuple(self.get(a) for a in axes)


def _data_axes(mesh_axes):
    return ("pod", "data") if "pod" in mesh_axes else ("data",)


def REGISTRATION_RULES(mesh_axes=("data",)) -> AxisRules:
    """Registration (``repro_torch.engine.shard``): pure data parallelism.

    The batch axis of volume stacks, control grids, optimiser state and loss
    traces shards over the data axes; every per-pair axis (volume geometry,
    grid geometry, the displacement channel, pyramid level, step) is
    replicated: each rank registers its own pairs end to end, so the
    optimisation loop has no collective.
    """
    d = _data_axes(mesh_axes)
    return AxisRules(
        batch=d,
        vol_x=None, vol_y=None, vol_z=None,  # volume geometry per pair
        grid_x=None, grid_y=None, grid_z=None,  # control-grid geometry
        disp=None,  # trailing (dx, dy, dz) displacement channel
        level=None,  # pyramid-level axis of the loss trace
        step=None,  # step axis of per-level loss traces
    )


def placements(mesh, axes) -> tuple:
    """``DTensor`` placements of a tensor whose dimensions are the logical
    ``axes``, on ``mesh`` (a ``DeviceMesh`` with named dimensions) under
    ``REGISTRATION_RULES`` of the mesh's names, the rules that also split
    the batch into each rank's rows (``engine.shard.batch_block``).

    Mesh dimension ``d`` shards tensor dimension ``i`` (``Shard(i)``) when
    ``axes[i]`` maps onto ``d``'s name, and replicates otherwise.
    """
    from torch.distributed.tensor import Replicate, Shard  # a second to import

    names = mesh.mesh_dim_names
    rules = REGISTRATION_RULES(names)
    out = []
    for name in names:
        dims = [i for i, target in enumerate(rules.spec(axes))
                if name == target or (isinstance(target, tuple) and name in target)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {name!r} shards more than one of {axes}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
