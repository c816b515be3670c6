"""Fused level step: the CUDA kernels' launches and their plain versions.

The kernels (``csrc/bsi_fused.cu``) replace the JAX package's Pallas kernel
``repro/kernels/bsi_fused.py:bsi_fused_pallas`` in five variants.  Per block
of tiles each evaluates the displacement, samples the moving volume
trilinearly at identity + displacement (fp32 coordinates, clamped to the
volume) and reduces the voxels of the volume to one partial row; a second
launch combines the rows lane by lane in a fixed order.  No dense field and
no warped volume reach device memory.  The displacement takes either form of
the JAX kernel's ``disp_form``: ``"lerp"``, the TTLI lerp stages (where the
JAX kernel runs its separable sweeps: the same function), or ``"matmul"``,
the 64-term Kronecker-basis sum of ``kernels.bsi_matmul``.

=========  =====================================================  ===========
variant    result                                                 lanes
=========  =====================================================  ===========
``ssd``    sum of ``(w - f)^2``                                   1
``stats``  sum, min, max and count of ``w``                       4
``ncc``    sums of ``ab``, ``aa``, ``bb``; ``a = w - mu_w``,       3
           ``b = f - mu_f``, the means from ``scal``
``nmi``    the ``(bins, bins)`` joint Parzen histogram            ``bins^2``
           ``sum_v wa(v) wb(v)^T`` of the min-max normalised
           intensities, lo/hi from ``scal``; the weights of
           the bins within :func:`nmi_support` of the nearest
           centre only (the rest are exactly 0), the product
           on the tensor cores in a 3xTF32 split
``lncc``   the sum of the local ``cc^2`` over the VALID window     2
           positions, and their count; a block owns a column
           of tiles and marches along x, warping each y-z
           slice of its tiles plus a ``window - 1`` halo once
           into a ring of ``window`` slices, summed x, y, z
=========  =====================================================  ===========

``ssd``, ``stats`` and ``ncc``, in both forms, run on the forward kernels'
blocks (:func:`moment_blocks`) and walk a block's voxel columns in aligned
lines of 32 voxels: the lerp form from the x-y stage of its (x tile, y
tile), the whole run in one pass; the matrix form chunk by chunk of z
tiles, each chunk's displacement first summed into shared memory from the
staged basis and control window, a thread two tiles of a column at a time.
``nmi`` runs on blocks of :func:`block_tiles`, ``lncc`` on
:func:`lncc_blocks`.

Under ``compute_dtype="bfloat16"`` every variant, in both forms, takes a
bf16 ``phi`` and ``moving`` (entry points ``bsi_fused_<variant>_bf16``;
``fixed`` and every sum stay float32), the contract of the JAX kernel
(``repro/kernels/bsi_fused.py:_fused_kernel``): the displacement in float32
from the widened grid and the bf16-rounded tables (the lerp LUTs, or the
matrix form's basis as the JAX kernel builds it from its bf16 LUTs,
:func:`basis_table`), rounded once to bf16 and widened, then the float32
warp of the widened bf16 intensities.  ``compute_dtype="float16"`` is the
same with fp16 in place of bf16 (``bsi_fused_<variant>_f16``).  The grid
is widened as it is staged and the warped samples are float32, so the
shared memory of every variant is the float32 kernel's and
:func:`moment_blocks`, :func:`block_tiles` and :func:`lncc_blocks` serve
every dtype.  The reduced stats walks keep lines of 32 voxels, aligned to
32 values of their streamed volume, the 2-byte moving one: a warp's reads
of a line are one aligned 64-byte half of a 128-byte line.

The ``plain_*`` functions compute the same results in tensor ops, without
autograd: the displacement (:func:`displacement`: ``bsi_ttli.plain`` or
``bsi_matmul``'s sum, both rounding each operation as the kernels do), the
clamped 8-tap sample and the sums.  ``kernels.ops`` picks between the two by
the tensor's device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.core.bspline import fused_basis
from repro_torch.core.similarity import local_cc, parzen_centres, parzen_weights
from repro_torch.kernels import bsi_matmul, bsi_ttli
from repro_torch.kernels.build import load_library

__all__ = ["DISP_FORMS", "LANES", "MAX_BINS", "NMI_STRIDE", "MomentBlocks", "basis_table",
           "block_tiles", "check_walk_layout", "displacement", "launch", "lncc_blocks",
           "moment_blocks", "nmi_padded_bins", "nmi_smem_bytes", "nmi_support",
           "nmi_support_range", "num_partials", "occupancy_key", "plain", "plain_lncc",
           "plain_ncc", "plain_nmi", "plain_stats", "warped"]

DISP_FORMS = ("lerp", "matmul")
LANES = {"ssd": 1, "stats": 4, "ncc": 3, "lncc": 2}
MAX_BINS = 64  # histogram width the nmi kernel takes (csrc: kNmiMaxBins)
NMI_CHUNK = 64  # voxels a team of the nmi kernel stages a round (csrc: kNmiChunk)
NMI_STRIDE = NMI_CHUNK + 4  # row stride of the staged weights, 4 mod 32 (csrc)
# expf(-d^2 / 2) is exactly 0.0f in float32 for d^2 above about 207.9 (below
# half the least denormal, 2^-150 = e^-103.97)
PARZEN_ZERO_D2 = 208.0
# shared memory of each of two blocks on one SM: 228 KB less 1 KB reserved a block
_TWO_BLOCKS_SMEM_BYTES = 233_472 // 2 - 1024
BASIS_ROW = 17  # float4 between the matrix-form walk's staged basis rows (csrc: kBasisRow)
WALK_TILES = 2  # z tiles of a column in an item of the matrix-form walk (csrc: kWalkTiles)
_H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def num_partials(vol_shape, tile, blocks) -> int:
    """Thread blocks of the fused launch: one per block of tiles in the volume."""
    n = 1
    for s, d, b in zip(vol_shape, tile, blocks):
        tiles = -(-s // d)
        n *= -(-tiles // b)
    return n


def nmi_padded_bins(bins) -> int:
    """The histogram's side padded to the kernel's mma tiles (csrc:
    nmi_padded_bins): 32 or 64."""
    return 32 if bins <= 32 else 64


def nmi_smem_bytes(bins) -> int:
    """Shared memory the nmi kernel adds to the staging (csrc:
    nmi_extra_floats): ``MAX_BINS`` centres, then for each of its two teams
    the two staged ``(bp, NMI_STRIDE)`` weight matrices (which the teams'
    partial histograms reuse)."""
    return 4 * (MAX_BINS + 2 * 2 * nmi_padded_bins(bins) * NMI_STRIDE)


def nmi_support(bins, sigma_ratio) -> int:
    """Half-width, in bins from the centre nearest a value, of the Parzen
    weights the nmi kernel evaluates: every centre within ``sqrt(208)``
    sigmas of the value (farther, the float32 weight is exactly 0), which the
    nearest centre puts up to half a bin farther off.  The least ``K`` with
    ``K - 1/2 > sqrt(208) sigma_ratio``, clipped to ``[0, bins)``; 8 at the
    default ``sigma_ratio`` of 0.5."""
    k = math.floor(math.sqrt(PARZEN_ZERO_D2) * sigma_ratio + 0.5) + 1
    return max(0, min(k, bins - 1))


def nmi_support_range(x, bins, support):
    """``(lo, hi)``: the bins the nmi kernel evaluates for each float32 value
    of ``x`` (csrc: nmi_support_range), those within ``support`` of the
    nearest centre (``x (bins - 1)`` clamped to the bins and rounded half to
    even); every bin for a NaN."""
    k0 = torch.round(torch.clamp(x * (bins - 1), 0, bins - 1)).long()
    lo = torch.clamp(k0 - support, min=0)
    hi = torch.clamp(k0 + support, max=bins - 1)
    nan = torch.isnan(x)
    return torch.where(nan, 0, lo), torch.where(nan, bins - 1, hi)


def _disp_smem_bytes(tile, blocks, disp_form) -> int:
    """Shared memory of the displacement stage (csrc: disp_smem_bytes)."""
    if disp_form == "lerp":
        return bsi_ttli.stage_smem_bytes(tile, blocks, 3)
    # the (d^3, 64) basis and the control window (csrc: basis_floats,
    # window_floats)
    (dx, dy, dz), (bx, by, bz) = tile, blocks
    return 4 * (64 * dx * dy * dz + (bx + 3) * (by + 3) * (bz + 3) * 3)


def block_tiles(tile, disp_form, extra_bytes=0) -> tuple:
    """Tiles per block of the nmi kernel (those of ``bsi_ttli.block_tiles``);
    raises if the displacement stage plus the variant's ``extra_bytes`` does
    not fit a block."""
    blocks = bsi_ttli.block_tiles(tile)
    smem = _disp_smem_bytes(tile, blocks, disp_form) + extra_bytes
    bsi_ttli.check_smem(f"the fused kernel at tile {tile} (disp_form={disp_form!r})",
                        smem)
    return blocks


@dataclasses.dataclass(frozen=True)
class MomentBlocks:
    """The blocks of the ssd, stats and ncc kernels for one volume in one
    displacement form (``csrc/bsi_fused.cu``: ``bsi_fused_walk_kernel``).

    Those of the forward kernels (:func:`repro_torch.kernels.bsi_ttli.
    forward_blocks`): a block owns one (x tile, y tile), so ``dx * dy``
    columns of voxels, and ``bz`` tiles along z, ``tiles = (1, 1, bz)``;
    ``grid`` is the launch's grid, blocks along (y, x, z).  A column's run
    in a block is ``run = bz * dz`` voxels, walked in lines of 32.  The lerp
    form walks the run in one pass (``chunk = bz``).  The matrix form takes
    it ``chunk`` z tiles at a time (the most that give each thread one item
    of :data:`WALK_TILES` tiles of a column, at most ``bz``): it computes the
    chunk's displacement, then walks it.  ``smem``: the lerp form's z table
    (16 bytes a voxel of a run) and y-stage values, ``dx * dy * (bz + 3) *
    3`` floats; the matrix form's ``(d^3, 64)`` basis (a row every
    :data:`BASIS_ROW` float4), two chunks' control windows (``16 *
    WALK_TILES * window_part(chunk)`` float4 each: each row's z points in
    ``WALK_TILES`` parts by their remainder; the next chunk's copied while
    the block computes this one's) and the chunk's displacement (``3 * dx *
    dy * chunk * dz`` floats)."""

    bz: int
    grid: tuple
    run: int
    chunk: int
    smem: int

    @property
    def tiles(self) -> tuple:
        return (1, 1, self.bz)


def window_part(chunk) -> int:
    """Float4 of a part of a staged window row of the matrix-form walk
    (csrc: walk_window_part): the z points of one remainder mod
    :data:`WALK_TILES` that a chunk's items read."""
    return (chunk + 2 * WALK_TILES + 1) // WALK_TILES


@functools.lru_cache(maxsize=None)
def moment_blocks(tile, vol_shape, disp_form="lerp") -> MomentBlocks:
    """The blocks of the ssd, stats and ncc kernels at ``tile`` for
    ``vol_shape`` in ``disp_form``: the forward kernels' (see
    :class:`MomentBlocks`); raises if they do not fit (the lerp form: as
    ``forward_blocks``, whose blocks hold more; the matrix form: its basis
    and chunk)."""
    tile, vol_shape = tuple(int(d) for d in tile), tuple(int(s) for s in vol_shape)
    if disp_form not in DISP_FORMS:
        raise ValueError(f"unknown disp_form {disp_form!r}; choose from {DISP_FORMS}")
    geo = bsi_ttli.forward_blocks(tile, 3, vol_shape)
    dx, dy, dz = tile
    if disp_form == "lerp":
        chunk, smem = geo.bz, 16 * geo.bz * dz + 4 * dx * dy * (geo.bz + 3) * 3
    else:
        chunk = min(geo.bz, WALK_TILES * max(1, bsi_ttli.KERNEL_THREADS // (dx * dy)))
        part = window_part(chunk)
        smem = (16 * (BASIS_ROW * dx * dy * dz + 2 * 16 * WALK_TILES * part)
                + 12 * dx * dy * chunk * dz)
        bsi_ttli.check_smem(f"the fused matrix-form walk at tile {tile}", smem)
    return MomentBlocks(bz=geo.bz, grid=geo.grid, run=geo.bz * dz, chunk=chunk, smem=smem)


@functools.lru_cache(maxsize=None)
def check_walk_layout(lib, dims) -> None:
    """Raise unless ``lib``'s walk (its ``bsi_fused_walk_layout``) lays out a
    block for ``dims``, the entry points' ``(nx, ny, nz, dx, dy, dz, X, Y, Z,
    bx, by, bz, form)``, as :func:`moment_blocks` does: the same chunk and
    dynamic shared memory, so that ``check_smem`` and :func:`occupancy_key`
    speak of the block the card runs.  The layout is the same for a bf16 or
    fp16 grid and volume (the block stages float32)."""
    out = (ctypes.c_longlong * 2)()
    rc = lib.bsi_fused_walk_layout(*dims, out)
    geo = moment_blocks(dims[3:6], dims[6:9], DISP_FORMS[dims[12]])
    if rc or (out[0], out[1]) != (geo.chunk, geo.smem):
        raise RuntimeError(
            f"the walk's layout in csrc (chunk {out[0]}, {out[1]} B; cudaError_t {rc}) is "
            f"not moment_blocks' (chunk {geo.chunk}, {geo.smem} B) for {dims}")


def occupancy_key(kind, disp_form, tile, vol_shape, dtype=torch.float32) -> tuple:
    """``(symbol, smem, grid)`` of the ``kind`` kernel (``ssd``, ``stats`` or
    ``ncc``) in ``disp_form`` (its kernel for a ``phi`` and ``moving`` of
    ``dtype``, on the same blocks for every dtype): the part of its
    instantiation's name in its ``-Xptxas -v`` line, its dynamic shared
    memory a block and its grid."""
    geo = moment_blocks(tuple(tile), tuple(vol_shape), disp_form)
    form, moment = DISP_FORMS.index(disp_form), ("ssd", "stats", "ncc").index(kind)
    name = bsi_ttli.kernel_symbol("bsi_fused_walk", dtype)
    return f"{name}ILi{form}ELi{moment}EE", geo.smem, geo.grid


def _lncc_smem_bytes(tile, own, window, disp_form) -> int:
    """Shared memory of the lncc kernel (csrc: LnccColumn, plus the static
    reduce buffer): the displacement's constants, the ring of ``window``
    warped and fixed y-z slices, their x sums and y sums."""
    g = [o + -(-(window - 1) // d) for o, d in zip(own, tile)]  # staged tiles
    E = [o * d for o, d in zip(own, tile)]
    sy, sz = E[1] + window - 1, E[2] + window - 1
    win = 3 * (g[0] + 3) * (g[1] + 3) * (g[2] + 3)
    if disp_form == "lerp":  # LUTs, window, two x- and two x-y-stage planes
        disp = 3 * sum(tile) + win + 2 * 3 * (g[1] + 3 + sy) * (g[2] + 3)
    else:  # basis, window
        disp = 64 * math.prod(tile) + win
    floats = disp + (2 * window + 5) * sy * sz + 5 * E[1] * sz
    return 4 * (floats + bsi_ttli.KERNEL_THREADS)


def _lncc_work(vol_shape, tile, own, window) -> int:
    """Thread slots the lncc blocks spend warping over ``vol_shape``: each
    block stages its own VALID positions + ``window - 1`` per axis and warps
    each staged y-z slice in rounds of the block's threads."""
    axes = []  # per axis: (blocks, staged voxels) of the full blocks and the last
    for n, d, o in zip(vol_shape, tile, own):
        valid, e = n - window + 1, o * d
        axes.append([(valid // e, e + window - 1), (1, valid % e + window - 1)]
                    if valid % e else [(valid // e, e + window - 1)])
    t = bsi_ttli.KERNEL_THREADS
    return sum(bx * by * bz * sx * -(-(sy * sz) // t) * t
               for bx, sx in axes[0] for by, sy in axes[1] for bz, sz in axes[2])


@functools.lru_cache(maxsize=None)
def lncc_blocks(tile, window, disp_form, vol_shape) -> tuple:
    """``(own, extra)`` tiles per block of the lncc kernel: the column a block
    owns (its march along x, its y-z footprint) and the halo tiles
    ``ceil((window - 1) / d)`` staged beyond them.

    Of the columns of at most 128 voxels along x and 64 along y and z whose
    shared memory lets two blocks share an SM (else one): those whose blocks
    fill the card's SMs twice over where any do (with fewer, SMs idle or run
    one block alone), then the one that spends the fewest thread slots
    warping ``vol_shape`` (:func:`_lncc_work`: each block recomputes its
    halo), then the one with the least shared memory.  Raises if a column of
    one tile does not fit."""
    bsi_ttli.check_smem(f"the fused lncc kernel at tile {tile}, window {window} "
                        f"(disp_form={disp_form!r})",
                        _lncc_smem_bytes(tile, (1, 1, 1), window, disp_form))
    tiles = [-(-s // d) for s, d in zip(vol_shape, tile)]
    caps = [min(t, max(1, c // d)) for t, d, c in zip(tiles, tile, (128, 64, 64))]
    extra = tuple(-(-(window - 1) // d) for d in tile)

    def most(ok, hi):
        """The largest x tiles in 1..hi for which ok holds (it holds up to
        some point, then fails), else 0."""
        lo = 0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if ok(mid) else (lo, mid - 1)
        return lo

    candidates = []
    for per_sm, budget in ((2, _TWO_BLOCKS_SMEM_BYTES), (1, bsi_ttli.MAX_SMEM_BYTES)):
        full = 2 * _H100_SMS * per_sm  # blocks of two full waves
        for oy in range(1, caps[1] + 1):
            for oz in range(1, caps[2] + 1):
                fits = most(lambda ox: _lncc_smem_bytes(tile, (ox, oy, oz), window,
                                                        disp_form) <= budget, caps[0])
                waves = most(lambda ox: num_partials(vol_shape, tile,
                                                     (ox, oy, oz)) >= full, fits)
                for own in {(ox, oy, oz) for ox in (fits, waves) if ox}:
                    candidates.append((
                        per_sm == 1, num_partials(vol_shape, tile, own) < full,
                        _lncc_work(vol_shape, tile, own, window),
                        _lncc_smem_bytes(tile, own, window, disp_form), own))
    return min(candidates)[-1], extra


def launch(kind, phi, moving, fixed, tile, blocks, *, disp_form="lerp", scal=None,
           bins=None, sigma=None, eps=None, window=None, extra=None, lib=None):
    """Launch variant ``kind`` on the current stream; returns its combined row
    (``(K,)`` float32, or ``(bins, bins)`` for ``nmi``).  ``phi`` and
    ``moving`` are both float32, both bf16 or both fp16 (with the LUTs or
    basis rounded to their dtype); ``fixed`` float32.  ``blocks``: the tiles a block
    owns, ``moment_blocks(...).tiles`` for ``ssd``, ``stats`` and ``ncc``;
    for ``lncc`` the owned tiles and ``extra`` the halo tiles.
    ``lib``: the loaded kernels (default :func:`load_library`'s; a
    measurement build's, ``load_library(defines)``, to time a variant)."""
    if kind not in (*LANES, "nmi"):
        raise ValueError(f"no fused kernel variant {kind!r}")
    nx, ny, nz, _ = phi.shape
    X, Y, Z = moving.shape
    n = num_partials(moving.shape, tile, blocks)
    k = bins * bins if kind == "nmi" else LANES[kind]
    partials = torch.empty(n * k, dtype=torch.float32, device=phi.device)
    out = torch.empty(k, dtype=torch.float32, device=phi.device)
    lib = lib or load_library()
    dims = (nx, ny, nz, *tile, X, Y, Z, *blocks, DISP_FORMS.index(disp_form))
    if kind in ("ssd", "stats", "ncc"):
        check_walk_layout(lib, dims)
    suffix = bsi_ttli.ENTRY_SUFFIX[phi.dtype]
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        if disp_form == "lerp":
            tabs = bsi_ttli.stage_luts(tile, phi.device, phi.dtype).data_ptr()
        else:
            tabs = basis_table(tile, phi.device, phi.dtype).data_ptr()
        entry = getattr(lib, f"bsi_fused_{kind}_{suffix}")
        if kind == "ssd":
            rc = entry(
                phi.data_ptr(), tabs, moving.data_ptr(), fixed.data_ptr(),
                partials.data_ptr(), n, out.data_ptr(), *dims, stream)
        elif kind == "stats":
            rc = entry(
                phi.data_ptr(), tabs, moving.data_ptr(), partials.data_ptr(), n,
                out.data_ptr(), *dims, stream)
        elif kind == "ncc":
            rc = entry(
                phi.data_ptr(), tabs, moving.data_ptr(), fixed.data_ptr(),
                scal.data_ptr(), partials.data_ptr(), n, out.data_ptr(), *dims, stream)
        elif kind == "nmi":
            centres = parzen_centres(bins, phi.device)
            rc = entry(
                phi.data_ptr(), tabs, moving.data_ptr(), fixed.data_ptr(),
                scal.data_ptr(), centres.data_ptr(), partials.data_ptr(), n,
                out.data_ptr(), *dims, bins, nmi_support(bins, sigma * (bins - 1)),
                ctypes.c_float(sigma), ctypes.c_float(eps), stream)
        else:
            rc = entry(
                phi.data_ptr(), tabs, moving.data_ptr(), fixed.data_ptr(),
                partials.data_ptr(), n, out.data_ptr(), *dims, *extra, window,
                ctypes.c_float(1.0 / window**3), ctypes.c_float(eps), stream)
    if rc:
        raise RuntimeError(f"bsi_fused {kind} kernel launch failed: cudaError_t {rc}")
    return out.view(bins, bins) if kind == "nmi" else out


@functools.lru_cache(maxsize=None)
def basis_table(tile, device, dtype=torch.float32) -> torch.Tensor:
    """The matrix form's ``(d^3, 64)`` basis for ``phi`` of ``dtype``, held
    as float32 on ``device``: ``core.bspline.fused_basis``, for bf16 or fp16
    the products of the LUTs of that dtype each rounded to it, as the JAX
    kernel builds it (``bsi_matmul.basis`` rounds the float64 product once
    instead)."""
    return fused_basis(tile, dtype, device).float().contiguous()


def displacement(phi, tile, vol_shape, disp_form="lerp"):
    """The kernels' displacement of ``disp_form`` in tensor ops, cropped to
    ``vol_shape``: ``bsi_ttli.plain``, or the 64-term sum of
    ``bsi_matmul.plain`` with the basis of :func:`basis_table`; of a bf16 or
    fp16 ``phi`` the float32 sums of the widened grid rounded once to its
    dtype."""
    if disp_form == "lerp":
        return bsi_ttli.plain(phi, tile, vol_shape)
    b = basis_table(tuple(int(d) for d in tile), phi.device, phi.dtype)
    return bsi_matmul.basis_sum(phi.float(), b, tile, vol_shape).to(phi.dtype)


def warped(phi, moving, tile, disp_form="lerp"):
    """The kernels' warp in tensor ops: the moving volume sampled at identity
    + the :func:`displacement` of ``disp_form``, clamped 8-tap, without
    autograd.  A bf16 or fp16 ``phi`` gives a displacement of its dtype (the
    float32 form rounded once), widened for the float32 coordinates; a bf16
    or fp16 ``moving`` gives taps of its dtype lerped in float32; the warp
    is float32."""
    X, Y, Z = moving.shape
    if disp_form not in DISP_FORMS:
        raise ValueError(f"unknown disp_form {disp_form!r}; choose from {DISP_FORMS}")
    with torch.no_grad():
        disp = displacement(phi, tile, (X, Y, Z), disp_form)
        dev = moving.device
        axes = [torch.arange(s, dtype=torch.float32, device=dev) for s in (X, Y, Z)]
        ident = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=dev)
        c = torch.minimum(torch.clamp(ident + disp, min=0.0), hi)
        f = torch.floor(c)
        t = c - f
        i0 = f.long()
        i1 = torch.minimum(i0 + 1, hi.long())
        flat = moving.reshape(-1)

        def at(ix, iy, iz):
            return flat[(ix * Y + iy) * Z + iz]

        x0, y0, z0 = i0.unbind(-1)
        x1, y1, z1 = i1.unbind(-1)
        tx, ty, tz = t.unbind(-1)
        c00 = at(x0, y0, z0) * (1 - tx) + at(x1, y0, z0) * tx
        c01 = at(x0, y0, z1) * (1 - tx) + at(x1, y0, z1) * tx
        c10 = at(x0, y1, z0) * (1 - tx) + at(x1, y1, z0) * tx
        c11 = at(x0, y1, z1) * (1 - tx) + at(x1, y1, z1) * tx
        c0 = c00 * (1 - ty) + c10 * ty
        c1 = c01 * (1 - ty) + c11 * ty
        return c0 * (1 - tz) + c1 * tz


def plain(phi, moving, fixed, tile, *, disp_form="lerp"):
    """The ssd kernel's function: the sum of squared differences."""
    w = warped(phi, moving, tile, disp_form)
    with torch.no_grad():
        return torch.sum((w - fixed) ** 2)


def plain_stats(phi, moving, tile, *, disp_form="lerp"):
    """The stats kernel's function: ``(sum, min, max, count)`` of the warp."""
    w = warped(phi, moving, tile, disp_form)
    with torch.no_grad():
        count = w.new_full((), float(w.numel()))
        return torch.stack([torch.sum(w), torch.min(w), torch.max(w), count])


def plain_ncc(phi, moving, fixed, scal, tile, *, disp_form="lerp"):
    """The ncc kernel's function: the centred ``(sum ab, sum aa, sum bb)``
    with ``scal = (mu_w, mu_f)``."""
    w = warped(phi, moving, tile, disp_form)
    with torch.no_grad():
        a = w - scal[0]
        b = fixed - scal[1]
        return torch.stack([torch.sum(a * b), torch.sum(a * a), torch.sum(b * b)])


def plain_nmi(phi, moving, fixed, scal, tile, *, bins, sigma, eps, disp_form="lerp"):
    """The nmi kernel's function: the un-normalised ``(bins, bins)`` joint
    Parzen histogram, ``scal = (lo_w, hi_w, lo_f, hi_f)``, ``sigma`` a float."""
    w = warped(phi, moving, tile, disp_form).reshape(-1)
    with torch.no_grad():
        floor = w.new_full((), 1e-8)
        an = (w - scal[0]) / torch.maximum(scal[1] - scal[0], floor)
        bn = (fixed.reshape(-1) - scal[2]) / torch.maximum(scal[3] - scal[2], floor)
        centres = parzen_centres(bins, w.device)
        s = w.new_full((), sigma)
        wa = parzen_weights(an, centres, s, eps)
        wb = parzen_weights(bn, centres, s, eps)
        return wa.T @ wb


def plain_lncc(phi, moving, fixed, tile, *, window, eps, disp_form="lerp"):
    """The lncc kernel's function: ``(sum cc, count)`` of the local ``cc^2``
    map of :func:`repro_torch.core.similarity.local_cc` (``window`` already
    clamped to the volume), float32 ``(2,)``."""
    w = warped(phi, moving, tile, disp_form)
    with torch.no_grad():
        cc = local_cc(w, fixed, window, eps)
        return torch.stack([torch.sum(cc), cc.new_full((), float(cc.numel()))])
