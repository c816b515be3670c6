"""Parameter schemas: one declaration -> seeded parameters.

A model declares its parameters as a nested dict of ``P(shape, axes)``
leaves, as the JAX package's ``repro/models/schema.py`` does; ``axes`` are
its logical axis names, kept so the declarations copy over, and read here
only to find a stacked leaf's fan-in.  The JAX package's ``abstract_params``
and partition specs shape its dry run and sharding and are not ported.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional

import torch

__all__ = ["P", "init_params", "leaf_paths", "map_schema", "lead"]


def lead(layers):
    """(shape-prefix, axes-prefix) for stacked-layer params.

    ``layers`` may be None (unstacked), an int (one stack) or a tuple
    (nested stacks)."""
    if layers is None:
        return (), ()
    if isinstance(layers, int):
        layers = (layers,)
    return tuple(layers), ("layers",) * len(layers)


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter declaration."""
    shape: tuple
    axes: tuple            # logical axis name (or None) per dim
    init: str = "normal"   # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in-ish)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_schema(fn, schema):
    """``schema`` with ``fn`` applied to every leaf, nesting kept."""
    if isinstance(schema, P):
        return fn(schema)
    return {k: map_schema(fn, v) for k, v in schema.items()}


def leaf_paths(tree, prefix=""):
    """``(dotted path, leaf)`` of every leaf of a nested dict, keys sorted."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from leaf_paths(tree[k], f"{prefix}.{k}" if prefix else k)


def _leaf_scale(p: P) -> float:
    if p.scale is not None:
        return p.scale
    fan_in = p.shape[0] if len(p.shape) >= 2 else max(p.shape[-1], 1)
    # stacked-layer params: fan-in is the second axis
    if p.axes and p.axes[0] == "layers" and len(p.shape) >= 3:
        fan_in = p.shape[1]
    return 1.0 / float(math.sqrt(max(fan_in, 1)))


def init_params(schema, generator, dtype=torch.float32, device="cpu"):
    """Real parameters: normal x ``_leaf_scale``, zeros or ones per leaf.

    Each normal leaf draws from its own generator on ``device``, seeded by
    the CRC-32 of the leaf's dotted path started from ``generator``'s seed
    (its low 32 bits, all a CPU generator reads), so a leaf's
    values depend on neither the process (the JAX package's init folds in
    Python's salted ``hash``) nor the order of the leaves.  The values are
    not the JAX package's: tests carry its parameters across instead.
    """
    out = {}
    for path, p in leaf_paths(schema):
        if p.init == "zeros":
            val = torch.zeros(p.shape, dtype=dtype, device=device)
        elif p.init == "ones":
            val = torch.ones(p.shape, dtype=dtype, device=device)
        else:
            g = torch.Generator(device=device)
            g.manual_seed(zlib.crc32(path.encode(), generator.initial_seed() % 2**32))
            val = torch.randn(p.shape, generator=g, dtype=torch.float32,
                              device=device).mul_(_leaf_scale(p)).to(dtype)
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return out
