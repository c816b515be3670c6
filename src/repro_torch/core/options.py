"""Registration options: one frozen, validated, hashable configuration object.

The fields, defaults and validation follow the JAX package's
``RegistrationOptions``, with three value sets renamed for PyTorch:

=============  ===============================  ==========================
field          JAX package                      this package
=============  ===============================  ==========================
``impl``       ``jnp``, ``pallas``, ``auto``    ``torch``, ``cuda``, ``auto``
``grad_impl``  ``xla``, ``jnp``, ``pallas``,    ``autograd``, ``torch``,
               ``matmul``, ``auto``             ``cuda``, ``matmul``, ``auto``
``fused``      ``auto``, ``on``, ``off``        ``auto``, ``on``, ``off``
=============  ===============================  ==========================

``torch`` is the plain tensor form and ``cuda`` the hand-written kernel (its
plain version on a CPU tensor); ``grad_impl="matmul"`` is the
transposed-matmul adjoint kernel, as in the JAX package.  ``"auto"`` on
``mode``, ``impl``, ``grad_impl`` or ``fused`` leaves the axis to the
autotuner (``engine.autotune.resolve_options``, which ``ffd_register``
calls).  The defaults run the kernels, ``mode="ttli", impl="cuda",
grad_impl="cuda"``, with ``fused="auto"`` as in the JAX package (whose
defaults are all ``"auto"``).  ``transform``, ``regularizer``,
``optimizer`` and ``stop`` take every value the JAX package takes and
refuse what it refuses: ``fused="on"`` with the velocity transform or with
Gauss-Newton, Gauss-Newton with a similarity other than SSD, a ``stop``
that is not a ``ConvergenceConfig``.  ``compute_dtype`` is canonicalised
to a dtype name as in the JAX package (``torch.bfloat16``, ``"bfloat16"``,
``torch.float16``, ``"float16"`` and ``"float32"`` are accepted; any other
type, ``int8`` say, raises ``ValueError``).

Entry points take ``options=``; the JAX package's legacy keyword spelling
(``ffd_register(f, m, tile=..., iters=...)``) still works through
:func:`merge_legacy_options`, which warns once per call site and builds the
same options object, so both spellings return bit-identical results.
"""

from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import Any

from repro_torch.core.interpolate import (GRAD_IMPLS, IMPLS, KERNEL_MODES, MODE_NAMES,
                                          compute_dtype_name)

__all__ = ["UNSET", "RegistrationOptions", "merge_legacy_options"]


class _Unset:
    """Sentinel: a keyword that was not passed, as against an explicit value."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "UNSET"

    def __bool__(self):
        return False


UNSET = _Unset()

_FUSED = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class RegistrationOptions:
    """The full registration configuration, validated and hashable.

    Fields
    ------
    tile:            control-point spacing ``(dx, dy, dz)``.
    levels:          pyramid levels (coarse-to-fine, 2x downsampling).
    iters:           optimiser steps per level.
    lr:              learning rate.
    bending_weight:  weight of the bending-energy proxy.
    mode:            BSI form (``gather`` | ``tt`` | ``ttli`` | ``separable``
                     | ``matmul`` | ``auto``); ``matmul`` also picks the fused
                     step's matrix-form displacement.
    impl:            forward: ``torch`` (plain form), ``cuda`` (the mode's
                     kernel; every mode but ``gather``) or ``auto``.
    grad_impl:       adjoint: ``autograd`` | ``torch`` | ``cuda`` (separable
                     kernel) | ``matmul`` (transposed-matmul kernel) |
                     ``auto``.
    compute_dtype:   None (float32 throughout) or a dtype name:
                     ``"bfloat16"`` (``"float16"``) runs BSI and the warp's
                     sampled intensities in bf16 (fp16) while the
                     parameters, the optimiser state, the adjoints'
                     accumulation and the objective stay float32
                     (``core.interpolate``); ``"float32"`` is float32
                     throughout.
    similarity:      ``"ssd"``, ``"ncc"``, ``"lncc"``, ``"nmi"``, a factory
                     variant (``nmi(bins=16)``) or a ``(warped, fixed) ->
                     scalar`` callable.
    transform:       ``"displacement"`` or ``"velocity"`` (a stationary
                     velocity field, scaling and squaring), or a spec
                     (``velocity(squarings=4)``).
    regularizer:     ``"none"`` (the ``bending_weight`` proxy) or
                     ``"bending"`` (the analytic energy, in place of the
                     proxy), or a spec (``bending(weight=5e-3)``).
    stop:            None (a fixed ``iters`` per level) or an
                     ``engine.convergence.ConvergenceConfig``.
    fused:           ``"auto"`` (the default): the faster of the fused and
                     unfused level step on the card, ``"off"`` on the CPU
                     and for a similarity with no fused kernel; ``"on"``:
                     the fused level-step kernel (raises for a similarity
                     with none); ``"off"``: the unfused dense field -> warp
                     -> similarity.
    optimizer:       ``"adam"``, ``"lbfgs"`` or ``"gauss_newton"`` (needs
                     ``similarity="ssd"`` and an unfused step), or a spec.
    fused_reason:    why ``fused`` resolved as it did, set by
                     ``engine.autotune.resolve_options`` on its output; None
                     on options built by hand.  Excluded from equality and
                     the hash: it is introspection, not configuration.
    """

    tile: tuple = (5, 5, 5)
    levels: int = 2
    iters: int = 40
    lr: float = 0.5
    bending_weight: float = 5e-3
    mode: str = "ttli"
    impl: str = "cuda"
    grad_impl: str = "cuda"
    compute_dtype: Any = None
    similarity: Any = "ssd"
    transform: Any = "displacement"
    regularizer: Any = "none"
    stop: Any = None
    fused: str = "auto"
    optimizer: Any = "adam"
    fused_reason: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        from repro_torch.core.regularizer import resolve_regularizer
        from repro_torch.core.similarity import fused_spec, resolve_similarity
        from repro_torch.core.transform import VelocityTransform, resolve_transform
        from repro_torch.engine.convergence import ConvergenceConfig
        from repro_torch.engine.optimizer import GaussNewtonOptimizer, resolve_optimizer

        tile = tuple(int(t) for t in self.tile)
        if len(tile) != 3 or any(t < 1 for t in tile):
            raise ValueError(f"tile must be 3 positive ints, got {self.tile!r}")
        object.__setattr__(self, "tile", tile)
        for name in ("levels", "iters"):
            v = int(getattr(self, name))
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
            object.__setattr__(self, name, v)
        for name in ("lr", "bending_weight"):
            v = float(getattr(self, name))
            if not v >= 0 or (name == "lr" and v == 0):
                raise ValueError(f"{name} must be positive, got {v}")
            object.__setattr__(self, name, v)
        if self.fused in (True, False):  # bool spelling
            object.__setattr__(self, "fused", "on" if self.fused else "off")
        if self.compute_dtype is not None:
            object.__setattr__(self, "compute_dtype", compute_dtype_name(self.compute_dtype))
        for name, allowed in (("mode", MODE_NAMES + ("auto",)),
                              ("impl", IMPLS + ("auto",)),
                              ("grad_impl", GRAD_IMPLS + ("auto",)), ("fused", _FUSED)):
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"{name} must be one of {allowed}, got {getattr(self, name)!r}")
        # the checks below need concrete values; the autotuner's pool holds
        # no candidate they would refuse
        if self.impl == "cuda" and self.mode not in KERNEL_MODES + ("auto",):
            raise ValueError(f"mode={self.mode!r} has no kernel; use impl='torch'")
        if self.grad_impl == "autograd" and self.impl == "cuda":
            raise ValueError(
                "grad_impl='autograd' differentiates the plain forward; "
                "impl='cuda' needs grad_impl='cuda', 'matmul' or 'torch'")
        if not (callable(self.similarity) or isinstance(self.similarity, str)):
            raise TypeError(
                "similarity must be a registered name or a loss callable, "
                f"got {self.similarity!r}")
        resolve_similarity(self.similarity)
        spec = fused_spec(self.similarity)
        if self.fused == "on" and spec is None:
            raise ValueError(
                f"similarity {self.similarity!r} has no fused kernel; use fused='off'")
        object.__setattr__(self, "transform", resolve_transform(self.transform))
        object.__setattr__(self, "regularizer", resolve_regularizer(self.regularizer))
        object.__setattr__(self, "optimizer", resolve_optimizer(self.optimizer))
        if self.fused == "on" and isinstance(self.transform, VelocityTransform):
            raise ValueError(
                "fused='on' is incompatible with transform='velocity': the fused "
                "level step cannot interleave the scaling-and-squaring compositions; "
                "use fused='auto' or 'off'")
        if isinstance(self.optimizer, GaussNewtonOptimizer):
            sim_key, _ = resolve_similarity(self.similarity)
            if sim_key != "ssd":
                raise ValueError(
                    "optimizer='gauss_newton' needs the least-squares residual form "
                    f"only similarity='ssd' provides, got similarity={self.similarity!r}; "
                    "use optimizer='lbfgs' for other similarities")
            if self.fused == "on":
                raise ValueError(
                    "fused='on' is incompatible with optimizer='gauss_newton': the "
                    "fused level step never forms the residual volume Gauss-Newton "
                    "linearises; use fused='auto' or 'off'")
        if self.stop is not None and not isinstance(self.stop, ConvergenceConfig):
            raise TypeError(
                f"stop must be a ConvergenceConfig or None, got {self.stop!r}; "
                "e.g. stop=ConvergenceConfig(tol=1e-4)")

    def replace(self, **changes) -> "RegistrationOptions":
        """A copy with the given fields replaced (validated again)."""
        return dataclasses.replace(self, **changes)

    def normalized(self) -> "RegistrationOptions":
        """The canonical copy: ``similarity`` as its registry key and ``stop``
        with ``max_iters`` resolved against ``iters``."""
        from repro_torch.core.similarity import resolve_similarity
        from repro_torch.engine.convergence import check_stop

        sim_key, _ = resolve_similarity(self.similarity)
        return dataclasses.replace(self, similarity=sim_key,
                                   stop=check_stop(self.stop, self.iters))

    def for_affine(self) -> "RegistrationOptions":
        """The options of the affine path: it reads only ``iters``, ``lr``,
        ``similarity``, ``stop`` and ``optimizer``, so every FFD field is
        pinned to this package's default, and ``fused`` to ``"off"`` (the
        affine model has no level step to fuse)."""
        base = RegistrationOptions()
        return self.normalized().replace(
            tile=base.tile, levels=base.levels, bending_weight=base.bending_weight,
            mode=base.mode, impl=base.impl, grad_impl=base.grad_impl,
            compute_dtype=base.compute_dtype, transform=base.transform,
            regularizer=base.regularizer, fused="off")


# One DeprecationWarning per (entry point, call site), whatever the process's
# warning filters; tests reset it with _reset_deprecation_registry().
_WARNED_SITES: set = set()


def _reset_deprecation_registry():
    _WARNED_SITES.clear()


def merge_legacy_options(fn_name, options, legacy: dict, *, defaults=None,
                         stacklevel=3) -> RegistrationOptions:
    """The deprecation shim behind the registration entry points.

    ``legacy`` maps field name -> value or :data:`UNSET` for the keyword
    arguments the entry point still accepts.  ``options=`` with no legacy
    keyword passes through; legacy keywords (or nothing) overlay
    ``defaults`` (``RegistrationOptions()`` by default) into a fresh
    :class:`RegistrationOptions`, and if any was passed a
    ``DeprecationWarning`` names them, once per call site.  Both at once
    raise ``TypeError``: preferring one would make the other a no-op.
    """
    passed = {k: v for k, v in legacy.items() if v is not UNSET}
    if options is not None:
        if not isinstance(options, RegistrationOptions):
            raise TypeError(f"{fn_name}: options must be a RegistrationOptions, "
                            f"got {type(options).__name__}")
        if passed:
            raise TypeError(f"{fn_name}: pass either options= or the legacy keyword "
                            f"arguments {sorted(passed)}, not both")
        return options
    if passed:
        frame = sys._getframe(stacklevel - 1)
        site = (fn_name, frame.f_code.co_filename, frame.f_lineno)
        if site not in _WARNED_SITES:
            _WARNED_SITES.add(site)
            spelled = ", ".join(f"{k}=..." for k in sorted(passed))
            warnings.warn(
                f"{fn_name}: the keyword arguments {sorted(passed)} are deprecated; "
                f"pass options=RegistrationOptions({spelled}) instead (see "
                "repro_torch.core.options)", DeprecationWarning, stacklevel=stacklevel)
    base = RegistrationOptions() if defaults is None else defaults
    return base.replace(**passed) if passed else base
