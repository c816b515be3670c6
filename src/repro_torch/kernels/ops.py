"""Dispatchers of the hand-written kernels: checks, allocation, launch, count.

Each dispatcher takes tensors in the JAX package's layouts (channels last;
attention's ``(B, S, heads, head dim)``).  On a CPU tensor it runs its
kernel's plain PyTorch version; on a CUDA tensor it checks device, dtype
(float32; attention also bfloat16), shape and contiguity, allocates the outputs
with ``torch.empty``, launches the kernel on the current stream, raises if
the launch failed, and adds one to its kernel's launch count
(:func:`launch_counts`; the fused variants count apart per displacement
form, ``bsi_fused_ncc`` and ``bsi_fused_ncc_matmul``).  There is no
fallback: a CUDA tensor runs the kernel or raises.

The JAX package's VMEM budget and its volume-in-VMEM gate of the fused
kernel describe a TPU and are not carried over; the kernels pick their own
block sizes from shared memory (``kernels.bsi_ttli.forward_blocks``, shared by
``kernels.bsi_separable``; ``kernels.bsi_tt.tt_blocks``,
``kernels.bsi_matmul.matmul_blocks``, ``kernels.bsi_fused.lncc_blocks``,
``kernels.bsi_fused.moment_blocks``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.similarity import entropy_loss
from repro_torch.kernels import bsi_adjoint as _adjoint
from repro_torch.kernels import bsi_fused as _fused
from repro_torch.kernels import bsi_matmul as _matmul
from repro_torch.kernels import bsi_separable as _separable
from repro_torch.kernels import bsi_tt as _tt
from repro_torch.kernels import bsi_ttli as _ttli
from repro_torch.kernels import flash_attention as _flash

__all__ = [
    "FORWARD_KERNELS",
    "bsi_ttli",
    "bsi_separable",
    "bsi_tt",
    "bsi_matmul",
    "bsi_adjoint",
    "bsi_adjoint_matmul",
    "flash_attention",
    "fused_lncc",
    "fused_ncc_moments",
    "fused_nmi_histogram",
    "fused_similarity_loss",
    "fused_ssd_loss",
    "fused_stats",
    "launch_counts",
    "reset_launch_counts",
    "two_pass_loss",
]


def _fused_name(kind, disp_form):
    """The launch-count key of fused variant ``kind`` in ``disp_form``."""
    name = "bsi_fused" if kind == "ssd" else f"bsi_fused_{kind}"
    return name if disp_form == "lerp" else f"{name}_matmul"


# Launches per kernel since the last reset.
_KERNELS = ("bsi_ttli", "bsi_separable", "bsi_tt", "bsi_matmul", "bsi_adjoint",
            "bsi_adjoint_matmul") + tuple(
    _fused_name(kind, form) for form in _fused.DISP_FORMS
    for kind in ("ssd", "stats", "ncc", "nmi", "lncc")) + ("flash_attention",)
_LAUNCHES = dict.fromkeys(_KERNELS, 0)


def reset_launch_counts():
    """Set every kernel's launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return dict(_LAUNCHES)


def _on_card(t, name) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for anything else."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def _check(t, name, ndim, device, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _covers(grid_shape, tile, vol_shape, name):
    for n, d, s in zip(grid_shape, tile, vol_shape):
        if not 1 <= s <= (n - 3) * d:
            raise ValueError(
                f"{name}: control grid {tuple(grid_shape)} at tile {tile} does "
                f"not cover volume {tuple(vol_shape)}"
            )


def _forward(name, module, phi, tile, vol_shape):
    tile = tuple(int(d) for d in tile)
    full = tuple((int(n) - 3) * d for n, d in zip(phi.shape[:3], tile))
    vol_shape = full if vol_shape is None else tuple(int(s) for s in vol_shape)
    _covers(phi.shape[:3], tile, vol_shape, name)
    if not _on_card(phi, name):
        return module.plain(phi, tile, vol_shape)
    _check(phi, "phi", 4, phi.device)
    out = torch.empty(vol_shape + (phi.shape[3],), dtype=torch.float32,
                      device=phi.device)
    module.launch(phi, out, tile)
    _LAUNCHES[name] += 1
    return out


def bsi_ttli(phi, tile, vol_shape=None):
    """Forward BSI, TTLI form, cropped to ``vol_shape`` (default: whole tiles).

    ``phi``: ``(Nx, Ny, Nz, C)`` control grid.  Returns the
    ``vol_shape + (C,)`` dense field.
    """
    return _forward("bsi_ttli", _ttli, phi, tile, vol_shape)


def bsi_separable(phi, tile, vol_shape=None):
    """Forward BSI, separable form (three per-axis sweeps), cropped to
    ``vol_shape`` (default: whole tiles); as :func:`bsi_ttli`."""
    return _forward("bsi_separable", _separable, phi, tile, vol_shape)


def bsi_tt(phi, tile, vol_shape=None):
    """Forward BSI, TT form (64-term weighted sum per voxel), cropped to
    ``vol_shape`` (default: whole tiles); as :func:`bsi_ttli`."""
    return _forward("bsi_tt", _tt, phi, tile, vol_shape)


def bsi_matmul(phi, tile, vol_shape=None):
    """Forward BSI, matrix form, cropped to ``vol_shape`` (default: whole
    tiles); as :func:`bsi_ttli`."""
    return _forward("bsi_matmul", _matmul, phi, tile, vol_shape)


# The forward kernel of each mode of ``core.interpolate.KERNEL_MODES``.
FORWARD_KERNELS = {"tt": bsi_tt, "ttli": bsi_ttli, "separable": bsi_separable,
                   "matmul": bsi_matmul}


def _adjoint_inputs(g, tile, grid_shape, name):
    tile = tuple(int(d) for d in tile)
    grid_shape = tuple(int(n) for n in grid_shape)
    _covers(grid_shape, tile, g.shape[:3], name)
    return tile, grid_shape, _on_card(g, name)


def bsi_adjoint(g, tile, grid_shape):
    """BSI adjoint: cotangent of the cropped field -> control-grid cotangent.

    ``g``: ``(X, Y, Z, C)`` with ``X <= (Nx - 3) * dx`` and so on; the voxels
    past the volume count as zero.  Returns ``grid_shape + (C,)`` float32.
    """
    tile, grid_shape, card = _adjoint_inputs(g, tile, grid_shape, "bsi_adjoint")
    if not card:
        return _adjoint.plain(g, tile, grid_shape)
    _check(g, "g", 4, g.device)
    out = torch.empty(grid_shape + (g.shape[3],), dtype=torch.float32,
                      device=g.device)
    _adjoint.launch(g, out, tile)
    _LAUNCHES["bsi_adjoint"] += 1
    return out


def bsi_adjoint_matmul(g, tile, grid_shape):
    """The BSI adjoint in the transposed matrix form; as :func:`bsi_adjoint`."""
    tile, grid_shape, card = _adjoint_inputs(g, tile, grid_shape, "bsi_adjoint_matmul")
    if not card:
        return _adjoint.plain_matmul(g, tile, grid_shape)
    _check(g, "g", 4, g.device)
    out = torch.empty(grid_shape + (g.shape[3],), dtype=torch.float32,
                      device=g.device)
    _adjoint.launch_matmul(g, out, tile)
    _LAUNCHES["bsi_adjoint_matmul"] += 1
    return out


def _fused_inputs(phi, moving, fixed, tile, name, disp_form):
    """Check the fused kernels' shared inputs; True on the card."""
    if disp_form not in _fused.DISP_FORMS:
        raise ValueError(
            f"unknown disp_form {disp_form!r}; choose from {_fused.DISP_FORMS}")
    if fixed is not None and moving.shape != fixed.shape:
        raise ValueError(
            f"shape mismatch: {tuple(fixed.shape)} vs {tuple(moving.shape)}")
    if phi.dim() != 4 or phi.shape[3] != 3:
        raise ValueError(f"phi must be (Nx, Ny, Nz, 3), got {tuple(phi.shape)}")
    _covers(phi.shape[:3], tile, moving.shape, name)
    if not _on_card(phi, name):
        return False
    _check(phi, "phi", 4, phi.device)
    _check(moving, "moving", 3, phi.device)
    if fixed is not None:
        _check(fixed, "fixed", 3, phi.device)
    return True


def _moment_blocks(tile, moving, disp_form):
    """The blocks of the ssd, stats and ncc kernels in ``disp_form``."""
    return _fused.moment_blocks(tile, tuple(int(s) for s in moving.shape), disp_form).tiles


def fused_ssd_loss(phi, moving, fixed, tile, *, disp_form="lerp"):
    """``mean((warp(moving, bsi(phi)) - fixed)**2)`` without a dense field.

    The fused level step's forward, SSD only; the differentiable face is
    ``repro_torch.core.ffd.fused_warp_loss``.  ``disp_form`` is ``"lerp"``
    or ``"matmul"`` (the displacement's form).  Returns a 0-dim float32
    tensor.
    """
    tile = tuple(int(d) for d in tile)
    n = moving.numel()
    if not _fused_inputs(phi, moving, fixed, tile, "fused_ssd_loss", disp_form):
        return _fused.plain(phi, moving, fixed, tile, disp_form=disp_form) / n
    total = _fused.launch("ssd", phi, moving, fixed, tile,
                          _moment_blocks(tile, moving, disp_form), disp_form=disp_form)
    _LAUNCHES[_fused_name("ssd", disp_form)] += 1
    return total[0] / n


def fused_stats(phi, moving, tile, *, disp_form="lerp"):
    """``(sum, min, max, count)`` of ``warp(moving, bsi(phi))``, float32 ``(4,)``;
    the first pass of the fused NCC and NMI."""
    tile = tuple(int(d) for d in tile)
    if not _fused_inputs(phi, moving, None, tile, "fused_stats", disp_form):
        return _fused.plain_stats(phi, moving, tile, disp_form=disp_form)
    out = _fused.launch("stats", phi, moving, None, tile,
                        _moment_blocks(tile, moving, disp_form), disp_form=disp_form)
    _LAUNCHES[_fused_name("stats", disp_form)] += 1
    return out


def fused_ncc_moments(phi, moving, fixed, scal, tile, *, disp_form="lerp"):
    """The centred ``(sum ab, sum aa, sum bb)`` of the warp ``w`` and ``fixed``,
    ``a = w - scal[0]``, ``b = fixed - scal[1]``; float32 ``(3,)``."""
    tile = tuple(int(d) for d in tile)
    if not _fused_inputs(phi, moving, fixed, tile, "fused_ncc_moments", disp_form):
        return _fused.plain_ncc(phi, moving, fixed, scal, tile, disp_form=disp_form)
    _check(scal, "scal", 1, phi.device)
    out = _fused.launch("ncc", phi, moving, fixed, tile,
                        _moment_blocks(tile, moving, disp_form), disp_form=disp_form,
                        scal=scal)
    _LAUNCHES[_fused_name("ncc", disp_form)] += 1
    return out


def fused_nmi_histogram(phi, moving, fixed, scal, tile, *, bins, sigma, eps,
                        disp_form="lerp"):
    """The un-normalised ``(bins, bins)`` joint Parzen histogram of the warp
    and ``fixed``, each min-max normalised with ``scal = (lo_w, hi_w, lo_f,
    hi_f)``; ``sigma`` in ``[0, 1]`` units, applied in float32."""
    tile = tuple(int(d) for d in tile)
    if not 2 <= bins <= _fused.MAX_BINS:
        raise ValueError(
            f"the fused nmi kernel takes 2 to {_fused.MAX_BINS} bins, got {bins}; "
            "run it unfused (fused='off')")
    if not _fused_inputs(phi, moving, fixed, tile, "fused_nmi_histogram", disp_form):
        return _fused.plain_nmi(phi, moving, fixed, scal, tile, bins=bins,
                                sigma=sigma, eps=eps, disp_form=disp_form)
    _check(scal, "scal", 1, phi.device)
    blocks = _fused.block_tiles(tile, disp_form, _fused.nmi_smem_bytes(bins))
    out = _fused.launch("nmi", phi, moving, fixed, tile, blocks, disp_form=disp_form,
                        scal=scal, bins=bins, sigma=sigma, eps=eps)
    _LAUNCHES[_fused_name("nmi", disp_form)] += 1
    return out


def lncc_window(window, vol_shape) -> int:
    """The LNCC window clamped to the volume's smallest extent, as
    ``core.similarity.uniform_filter`` clamps it."""
    return max(1, min(int(window), *(int(s) for s in vol_shape)))


def fused_lncc(phi, moving, fixed, tile, *, window, eps, disp_form="lerp"):
    """``(sum cc, count)`` of the local ``cc^2`` of the warp and ``fixed``
    over the VALID positions of a ``window`` (clamped to the volume), float32
    ``(2,)``."""
    tile = tuple(int(d) for d in tile)
    window = lncc_window(window, moving.shape)
    if not _fused_inputs(phi, moving, fixed, tile, "fused_lncc", disp_form):
        return _fused.plain_lncc(phi, moving, fixed, tile, window=window, eps=eps,
                                 disp_form=disp_form)
    own, extra = _fused.lncc_blocks(tile, window, disp_form,
                                    tuple(int(s) for s in moving.shape))
    out = _fused.launch("lncc", phi, moving, fixed, tile, own, disp_form=disp_form,
                        eps=float(eps), window=window, extra=extra)
    _LAUNCHES[_fused_name("lncc", disp_form)] += 1
    return out


def fused_similarity_loss(phi, moving, fixed, tile, *, sim_spec, disp_form="lerp"):
    """``sim(warp(moving, bsi(phi)), fixed)`` without a dense field.

    ``sim_spec`` is a similarity's ``_fused_spec``: ``ssd`` and ``lncc`` are
    one pass, ``ncc`` and ``nmi`` two (:func:`two_pass_loss`).  The
    displacement is the TTLI lerp form (``disp_form="lerp"``) or the matrix
    form (``"matmul"``).  Forward only; the differentiable face is
    ``repro_torch.core.ffd.fused_warp_loss``.  Returns a 0-dim float32
    tensor.
    """
    kind = sim_spec[0]
    if kind == "ssd":
        return fused_ssd_loss(phi, moving, fixed, tile, disp_form=disp_form)
    if kind == "lncc":
        _, window, eps = sim_spec
        window = lncc_window(window, moving.shape)
        acc = fused_lncc(phi, moving, fixed, tile, window=window, eps=eps,
                         disp_form=disp_form)
        npos = 1
        for s in moving.shape:
            npos *= int(s) - window + 1
        return 1.0 - acc[0] / npos
    return two_pass_loss(sim_spec, phi, moving, fixed, tile, stats=fused_stats,
                         ncc_moments=fused_ncc_moments,
                         nmi_histogram=fused_nmi_histogram, disp_form=disp_form)


def two_pass_loss(sim_spec, phi, moving, fixed, tile, *, stats, ncc_moments,
                  nmi_histogram, disp_form="lerp"):
    """The fused ``ncc`` or ``nmi`` loss from its two passes.

    Pass one is ``stats`` of the warp; pass two ``ncc_moments`` or
    ``nmi_histogram``, given the means or lo/hi as a small device buffer.  The
    finish is ``repro/kernels/ops.py:_fused_loss_jit``'s, in tensor ops on the
    device: nothing reads a value back to the host.  The passes are the
    dispatchers above or, to hold the kernels against them on the card, the
    kernels' plain versions (``kernels.bsi_fused``), which take the same
    arguments, ``disp_form`` among them.
    """
    kind = sim_spec[0]
    if kind not in ("ncc", "nmi"):
        raise ValueError(f"no fused kernel for similarity spec {sim_spec!r}")
    if moving.shape != fixed.shape:
        raise ValueError(
            f"shape mismatch: {tuple(fixed.shape)} vs {tuple(moving.shape)}")
    stats, ncc_moments, nmi_histogram = (
        functools.partial(f, disp_form=disp_form)
        for f in (stats, ncc_moments, nmi_histogram))
    n = moving.numel()
    st = stats(phi, moving, tile)
    if kind == "ncc":
        scal = torch.stack([st[0] / n, fixed.mean()])
        acc = ncc_moments(phi, moving, fixed, scal, tile)
        return 1.0 - acc[0] / torch.clamp_min(torch.sqrt(acc[1] * acc[2]), 1e-8)
    _, bins, sigma_ratio, eps = sim_spec
    bins = int(bins)
    scal = torch.stack([st[1], st[2], fixed.min(), fixed.max()])
    hist = nmi_histogram(phi, moving, fixed, scal, tile, bins=bins,
                         sigma=float(sigma_ratio) / (bins - 1), eps=float(eps))
    return entropy_loss(hist / n, float(eps))


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Causal / windowed / softcapped GQA attention by online softmax.

    q: ``(B, S, H, hd)``; k, v: ``(B, S, KV, hd)``, ``H % KV == 0``, all of
    one dtype (float32 or bfloat16); query and key positions are
    ``arange(S)``.  ``window > 0`` keeps the keys ``k > q - window``;
    ``softcap > 0`` caps the scores at ``tanh(s / softcap) * softcap``.
    Returns ``(B, S, H, hd)`` in q's dtype.  On the card both dtypes run on
    the tensor cores (``kernels.flash_attention``): bf16 by wgmma, float32 by
    mma.sync as three TF32 products; both take head dims
    ``kernels.flash_attention.HEAD_DIMS`` and contiguous tensors.
    """
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, S, KV, hd) = ({B}, {S}, KV, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not split into {k.shape[2]} key/value heads")
    if not _on_card(q, "flash_attention"):
        return _flash.plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, 4, q.device, q.dtype)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if hd not in _flash.HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head dims {_flash.HEAD_DIMS}, "
                         f"got {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _flash.launch(q, k, v, out, causal=causal, window=window, softcap=softcap)
    _LAUNCHES["flash_attention"] += 1
    return out
