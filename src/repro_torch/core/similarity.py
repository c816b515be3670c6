"""Similarity terms: ``(warped, fixed) -> scalar`` losses, lower = better.

Registered terms, as in the JAX package:

``ssd``   mean squared intensity difference, the mono-modal default.
``ncc``   ``1 - (global normalised cross-correlation)``.
``lncc``  windowed local NCC, ``1 - mean local cc^2``; the window clamps to
          the volume's smallest extent.
``nmi``   ``2 - NMI`` from a Parzen-window (Gaussian soft-binned) joint
          histogram, the multi-modal (CT to CBCT) term of NiftyReg's FFD
          workflow.  ``nmi(bins=...)`` builds variants.

Every built-in loss carries a ``_fused_spec`` tuple naming its kind and
parameters; ``kernels.ops.fused_similarity_loss`` needs nothing else, and
:func:`_loss_from_spec` rebuilds the same callable from it.  A loss callable
passes through unregistered and runs on the unfused level step.

``min`` and ``max`` are full reductions (``torch.min(x)``), whose gradient
splits the cotangent evenly over ties as ``jnp.min``'s does: a phantom
clipped to [0, 1] holds millions of voxels exactly at its minimum.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.ffd import _linspace
from repro_torch.core.registry import Registry

__all__ = [
    "SIMILARITIES",
    "available_similarities",
    "fused_spec",
    "lncc",
    "local_cc",
    "ncc",
    "ncc_loss",
    "nmi",
    "register_similarity",
    "resolve_similarity",
    "similarity_token",
    "ssd",
    "uniform_filter",
]

SIMILARITIES = Registry("similarity", passthrough=callable, hint="or pass a callable")


def register_similarity(name, fn=None):
    """Register ``fn`` as similarity ``name`` (also usable as a decorator)."""
    return SIMILARITIES.register(name, fn)


def available_similarities():
    """Sorted names of the registered similarity terms."""
    return SIMILARITIES.names()


def resolve_similarity(similarity):
    """Resolve a name-or-callable to ``(key, loss_fn)``."""
    return SIMILARITIES.resolve(similarity)


def fused_spec(similarity):
    """The fused-kernel spec tuple of ``similarity``, or None for a custom
    callable without one."""
    _, fn = resolve_similarity(similarity)
    return getattr(fn, "_fused_spec", None)


def _loss_from_spec(spec):
    """The loss a fused spec tuple describes: the inverse of :func:`fused_spec`.

    The factories are cached, so this returns the same callable the spec came
    from, and the fused step's backward differentiates the identical loss.
    """
    kind = spec[0]
    if kind == "ssd":
        return ssd
    if kind == "ncc":
        return ncc_loss
    if kind == "lncc":
        return lncc(spec[1], spec[2])
    if kind == "nmi":
        return nmi(spec[1], spec[2], spec[3])
    raise ValueError(f"unknown fused similarity spec {spec!r}")


def similarity_token(similarity) -> str:
    """A short string naming ``similarity`` for cache keys and logs."""
    if callable(similarity):
        return getattr(similarity, "__qualname__", repr(similarity))
    return str(similarity)


# --- shared pieces -----------------------------------------------------------


def _norm01(x):
    lo, hi = torch.min(x), torch.max(x)
    return (x - lo) / torch.maximum(hi - lo, x.new_full((), 1e-8))


def uniform_filter(x, size):
    """3-D VALID box filter; ``size`` clamps to the smallest volume extent.

    Summed as shifted slices, axis by axis, then scaled by ``1 / size^3``:
    exact float32 on any device (a float32 convolution would run in TF32
    on the card by default), and differentiable.
    """
    size = max(1, min(int(size), *(int(s) for s in x.shape)))
    for ax in range(3):
        n = x.shape[ax] - size + 1
        acc = x.narrow(ax, 0, n)
        for a in range(1, size):
            acc = acc + x.narrow(ax, a, n)
        x = acc
    return x * (1.0 / size**3)


# --- loss-form terms ---------------------------------------------------------


@register_similarity("ssd")
def ssd(warped, fixed):
    """Mean squared intensity difference (mono-modal default)."""
    return torch.mean((warped - fixed) ** 2)


ssd._fused_spec = ("ssd",)


def ncc(a, b):
    """Global normalised cross-correlation coefficient (in ``[-1, 1]``)."""
    a = a - torch.mean(a)
    b = b - torch.mean(b)
    den = torch.sqrt(torch.sum(a**2) * torch.sum(b**2))
    return torch.sum(a * b) / torch.maximum(den, den.new_full((), 1e-8))


@register_similarity("ncc")
def ncc_loss(warped, fixed):
    """``1 - NCC``: zero at perfect linear correlation."""
    return 1.0 - ncc(warped, fixed)


ncc_loss._fused_spec = ("ncc",)


def lncc(window=9, eps=1e-5):
    """Build a windowed local-NCC loss: ``1 - mean(local cc^2)``.

    Cached on the parameters' values, so equal parameters give the same
    callable however they are passed.
    """
    return _lncc(int(window), float(eps))


def local_cc(warped, fixed, window, eps):
    """The local ``cc^2`` map of LNCC over the VALID window positions:
    ``cross^2 / (var_w * var_f + eps)`` from the five windowed moments."""
    mu_w = uniform_filter(warped, window)
    mu_f = uniform_filter(fixed, window)
    var_w = uniform_filter(warped * warped, window) - mu_w**2
    var_f = uniform_filter(fixed * fixed, window) - mu_f**2
    cross = uniform_filter(warped * fixed, window) - mu_w * mu_f
    return cross**2 / (var_w * var_f + eps)


@functools.lru_cache(maxsize=None)
def _lncc(window, eps):
    def lncc_loss(warped, fixed):
        return 1.0 - torch.mean(local_cc(warped, fixed, window, eps))

    lncc_loss.__qualname__ = f"lncc(window={window},eps={eps:g})"
    lncc_loss._fused_spec = ("lncc", window, eps)
    return lncc_loss


@functools.lru_cache(maxsize=None)
def parzen_centres(bins, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, bins)`` in float32 on ``device``, made once."""
    return _linspace(0.0, 1.0, bins, device)


def parzen_weights(x, centres, sigma, eps):
    """``(V, bins)`` Gaussian Parzen weights of the values ``x`` (``(V,)``),
    each row normalised by its sum plus ``eps``.  ``sigma`` is a 0-dim tensor:
    a true division, as in the JAX package and the kernel."""
    w = torch.exp(-0.5 * ((x[:, None] - centres[None, :]) / sigma) ** 2)
    return w / (torch.sum(w, dim=1, keepdim=True) + eps)


def entropy_loss(pab, eps):
    """``2 - (H(a) + H(b)) / H(a, b)`` of a normalised joint histogram."""
    pa = torch.sum(pab, dim=1)
    pb = torch.sum(pab, dim=0)
    ha = -torch.sum(pa * torch.log(pa + eps))
    hb = -torch.sum(pb * torch.log(pb + eps))
    hab = -torch.sum(pab * torch.log(pab + eps))
    return 2.0 - (ha + hb) / (hab + eps)


def nmi(bins=32, sigma_ratio=0.5, eps=1e-8):
    """Build a differentiable NMI loss (Parzen soft-binned joint histogram).

    Intensities are min-max normalised to ``[0, 1]`` and spread onto ``bins``
    centres with Gaussian windows of ``sigma_ratio`` bin widths; the joint
    histogram is one ``(bins, V) @ (V, bins)`` product.  Returns ``2 - NMI``
    with ``NMI = (H(a) + H(b)) / H(a, b)`` in ``[1, 2]``: lower is better.
    Cached on the parameters' values, like :func:`lncc`.
    """
    bins = int(bins)
    if bins < 2:
        raise ValueError(f"nmi needs >= 2 bins, got {bins}")
    return _nmi(bins, float(sigma_ratio), float(eps))


@functools.lru_cache(maxsize=None)
def _nmi(bins, sigma_ratio, eps):
    sigma = sigma_ratio / (bins - 1)  # Python double, applied in float32

    def nmi_loss(warped, fixed):
        a = _norm01(warped).reshape(-1)
        b = _norm01(fixed).reshape(-1)
        centres = parzen_centres(bins, a.device)
        s = a.new_full((), sigma)
        wa = parzen_weights(a, centres, s, eps)
        wb = parzen_weights(b, centres, s, eps)
        pab = wa.T @ wb / a.shape[0]
        return entropy_loss(pab, eps)

    nmi_loss.__qualname__ = f"nmi(bins={bins},sigma_ratio={sigma_ratio:g},eps={eps:g})"
    nmi_loss._fused_spec = ("nmi", bins, sigma_ratio, eps)
    return nmi_loss


register_similarity("lncc", lncc())
register_similarity("nmi", nmi())
