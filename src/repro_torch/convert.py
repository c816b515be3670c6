"""Carry the JAX package's state into this package.

``grid_from_numpy`` takes a control grid as the JAX package returns it
(``RegistrationResult.params``, as a numpy array) and
``options_from_reference`` maps its option values to this package's names
(``reference_fields`` maps the BSI axes back), so both packages compute the
same thing from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.options import RegistrationOptions
from repro_torch.core.similarity import _loss_from_spec
from repro_torch.engine.optimizer import AdamOptimizer

__all__ = ["IMPL_NAMES", "GRAD_IMPL_NAMES", "grid_from_numpy", "options_from_reference",
           "reference_fields"]

# The JAX package's value -> this package's value.
IMPL_NAMES = {"jnp": "torch", "pallas": "cuda"}
GRAD_IMPL_NAMES = {"xla": "autograd", "jnp": "torch", "pallas": "cuda",
                   "matmul": "matmul"}


def grid_from_numpy(phi, device) -> torch.Tensor:
    """A ``(Nx, Ny, Nz, 3)`` control grid as a contiguous float32 tensor."""
    if np.ndim(phi) != 4 or np.shape(phi)[3] != 3:
        raise ValueError(
            f"expected a (Nx, Ny, Nz, 3) control grid, got {np.shape(phi)}")
    # a copy: numpy views of JAX arrays are read-only
    return torch.from_numpy(np.array(phi, dtype=np.float32)).to(device)


def _name(value):
    """A registry name for a value given as a name or as the JAX package's spec."""
    if isinstance(value, str) or callable(value) or value is None:
        return value
    return getattr(value, "name", value)


def _similarity(value):
    """A similarity of the JAX package as this package's: a name stays a name;
    a loss with a ``_fused_spec`` (``nmi(bins=16)``, ``lncc(window=5)``) maps
    to this package's loss with the same spec, never by calling the JAX
    function; any other callable passes through."""
    spec = getattr(value, "_fused_spec", None)
    if callable(value) and spec is not None:
        return _loss_from_spec(tuple(spec))
    return value


def options_from_reference(fields: dict) -> RegistrationOptions:
    """``RegistrationOptions`` of this package from the JAX package's fields.

    ``fields`` maps field names to values as the JAX package spells them
    (names, or its frozen spec instances).  ``impl`` and ``grad_impl`` are
    renamed by ``IMPL_NAMES`` and ``GRAD_IMPL_NAMES``; ``"auto"`` keeps its
    name; a value with no counterpart yet raises as the options do.
    A similarity callable of the JAX package maps to this package's callable
    with the same ``_fused_spec``.  ``fused_reason`` is the JAX package's
    introspection field and is dropped.
    """
    kw = {k: v for k, v in fields.items() if k != "fused_reason"}
    if "impl" in kw:
        kw["impl"] = IMPL_NAMES.get(kw["impl"], kw["impl"])
    if "grad_impl" in kw:
        kw["grad_impl"] = GRAD_IMPL_NAMES.get(kw["grad_impl"], kw["grad_impl"])
    if "similarity" in kw:
        kw["similarity"] = _similarity(kw["similarity"])
    for k in ("transform", "regularizer"):
        if k in kw:
            kw[k] = _name(kw[k])
    opt = kw.get("optimizer")
    if opt is not None and not isinstance(opt, str):
        if _name(opt) == "adam":
            kw["optimizer"] = AdamOptimizer(b1=opt.b1, b2=opt.b2, eps=opt.eps)
        else:
            kw["optimizer"] = _name(opt)
    return RegistrationOptions(**kw)


def reference_fields(options) -> dict:
    """``mode``, ``impl``, ``grad_impl`` and ``fused`` of ``options`` as the
    JAX package spells them: the inverse of :func:`options_from_reference`
    on those axes."""
    impl = {v: k for k, v in IMPL_NAMES.items()}
    grad_impl = {v: k for k, v in GRAD_IMPL_NAMES.items()}
    return dict(mode=options.mode, impl=impl.get(options.impl, options.impl),
                grad_impl=grad_impl.get(options.grad_impl, options.grad_impl),
                fused=options.fused)
