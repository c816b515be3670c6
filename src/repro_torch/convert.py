"""Carry the JAX package's state into this package.

``grid_from_numpy`` takes a control grid as the JAX package returns it
(``RegistrationResult.params``, as a numpy array), ``theta_from_numpy`` an
affine ``(3, 4)``, and ``options_from_reference`` maps its option values to
this package's names and specs, every spec's fields carried over
(``reference_fields`` maps the BSI axes back), so both packages compute the
same thing from the same numbers.  ``model_from_numpy`` and
``cache_from_numpy`` carry a language model's parameters and its KV cache
across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import regularizer, transform
from repro_torch.core.options import RegistrationOptions
from repro_torch.core.similarity import _loss_from_spec
from repro_torch.device import resolve_device
from repro_torch.engine import optimizer
from repro_torch.engine.convergence import ConvergenceConfig
from repro_torch.models.model import DecoderLM, map_tree

__all__ = ["IMPL_NAMES", "GRAD_IMPL_NAMES", "cache_from_numpy", "grid_from_numpy",
           "model_from_numpy", "options_from_reference", "reference_fields",
           "theta_from_numpy"]

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


def theta_from_numpy(theta, device) -> torch.Tensor:
    """A ``(3, 4)`` affine as a contiguous float32 tensor."""
    if np.shape(theta) != (3, 4):
        raise ValueError(f"expected a (3, 4) affine, got {np.shape(theta)}")
    return torch.from_numpy(np.array(theta, dtype=np.float32)).to(device)


# The JAX package's spec names -> this package's spec classes, per axis.
_SPECS = {
    "transform": {"displacement": transform.DisplacementTransform,
                  "velocity": transform.VelocityTransform},
    "regularizer": {"none": regularizer.NoRegularizer,
                    "bending": regularizer.BendingRegularizer},
    "optimizer": {"adam": optimizer.AdamOptimizer, "lbfgs": optimizer.LbfgsOptimizer,
                  "gauss_newton": optimizer.GaussNewtonOptimizer},
}


def _spec(axis, value):
    """A name passes through; a spec of the JAX package becomes this
    package's spec of the same name with the same fields."""
    if isinstance(value, str) or value is None:
        return value
    cls = _SPECS[axis].get(getattr(value, "name", None))
    if cls is None:
        return value  # the options refuse it with the valid names
    return cls(**{f.name: getattr(value, f.name) for f in dataclasses.fields(cls)})


def _stop(value):
    """The JAX package's ``ConvergenceConfig`` as this package's; anything
    else passes through for the options to refuse."""
    if value is None or isinstance(value, ConvergenceConfig):
        return value
    if type(value).__name__ != "ConvergenceConfig":
        return value
    return ConvergenceConfig(tol=value.tol, patience=value.patience,
                             max_iters=value.max_iters)


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
    with the same ``_fused_spec``; a transform, regularizer or optimizer
    spec, and a ``ConvergenceConfig``, to this package's with the same
    fields.  ``fused_reason`` is the JAX package's introspection field and
    is dropped.  ``compute_dtype`` keeps its canonical name
    (``"bfloat16"``, ``"float16"``).
    """
    kw = {k: v for k, v in fields.items() if k != "fused_reason"}
    if "impl" in kw:
        kw["impl"] = IMPL_NAMES.get(kw["impl"], kw["impl"])
    if "grad_impl" in kw:
        kw["grad_impl"] = GRAD_IMPL_NAMES.get(kw["grad_impl"], kw["grad_impl"])
    if "similarity" in kw:
        kw["similarity"] = _similarity(kw["similarity"])
    for k in _SPECS:
        if k in kw:
            kw[k] = _spec(k, kw[k])
    if "stop" in kw:
        kw["stop"] = _stop(kw["stop"])
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


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor of its dtype; bfloat16 arrays (``ml_dtypes``,
    which torch does not read) go through float32, exactly; numpy's own
    float16 is read as it is.  A copy: numpy views of JAX arrays are
    read-only."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def model_from_numpy(cfg, params, device="cuda") -> DecoderLM:
    """The JAX package's parameter tree (``repro.models.model.init_model``,
    as numpy arrays; block leaves stacked ``(L, ...)``) as this package's
    model, each parameter in its array's dtype.  On the card unless the
    caller passes ``device="cpu"``."""
    device = resolve_device(device, "the model")
    return DecoderLM.from_stacked(cfg, map_tree(lambda a: _tensor(a, device), params))


def cache_from_numpy(cache, device="cuda") -> dict:
    """The JAX package's KV cache (``prefill`` / ``decode_step``; numpy
    arrays, ``pos`` a 0-d integer) as this package's: the same stacked
    tensors and ``pos`` as a Python int.  On the card unless the caller
    passes ``device="cpu"``."""
    device = resolve_device(device, "the model")
    out = {k: _tensor(v, device) for k, v in cache.items() if k != "pos"}
    out["pos"] = int(cache["pos"])
    return out
