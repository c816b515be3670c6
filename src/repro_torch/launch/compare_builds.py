"""Every BSI kernel of this build and of another, on the same inputs, in each dtype both export.

    PYTHONPATH=src python -m repro_torch.launch.compare_builds --against LIB
        [--shape X Y Z] [--tile D D D]

``LIB`` is another build's library, as the parent commit's: unpack a ``git
archive`` of it under ``build/``, build its kernels there
(``kernels.build.load_library`` of that tree) and pass the ``.so``.  At the
paper's phantom1 volume (512 x 228 x 385, the default), tile 5^3, 3
channels, the entry point of each kernel runs in both libraries on the same
seeded inputs through this tree's launches, for every element type (float32,
bfloat16, float16) whose entry points both libraries export: the four
forward forms (``bsi_ttli``, ``bsi_separable``, ``bsi_tt``, ``bsi_matmul``),
both adjoints, and the five fused variants in both displacement forms (nmi
at 32 bins, lncc at window 9).  A reduced dtype's kernels take the float32
inputs rounded to it (the fixed volume stays float32), their rows named as
the launch counts name them (``bsi_tt_bf16``, ``bsi_fused_ncc_matmul_f16``).
Prints the dtypes compared and those skipped (an older build lacks an
element type's entry points), a line a kernel and a JSON summary; exits
non-zero unless some dtype was compared and every output of this build
equals the other's bit for bit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from repro_torch.core import ffd
from repro_torch.data.volumes import PAPER_VOLUMES
from repro_torch.device import card_name
from repro_torch.kernels import (bsi_adjoint, bsi_fused, bsi_matmul, bsi_separable, bsi_tt,
                                 bsi_ttli, ops)
from repro_torch.kernels.build import BuildInfo, Library, load_library

FORWARD = {"bsi_ttli": bsi_ttli, "bsi_separable": bsi_separable, "bsi_tt": bsi_tt,
           "bsi_matmul": bsi_matmul}


def inputs(vol, tile, seed=11):
    """A float32 grid, cotangent, moving and fixed volume on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gshape = ffd.grid_shape_for_volume(vol, tile)
    phi = torch.randn(gshape + (3,), generator=gen, device="cuda")
    g = torch.randn(vol + (3,), generator=gen, device="cuda") * 1e-3
    mov, fix = (torch.rand(vol, generator=gen, device="cuda") for _ in range(2))
    return phi, g, mov, fix


def exports(lib, dtype) -> bool:
    """Whether ``lib`` has the entry point of every kernel compared in ``dtype``."""
    sx = bsi_ttli.ENTRY_SUFFIX[dtype]
    stems = (*FORWARD, "bsi_adjoint", "bsi_adjoint_matmul",
             *(f"bsi_fused_{kind}" for kind in ("ssd", "stats", "ncc", "nmi", "lncc")))
    return all(hasattr(lib, f"{stem}_{sx}") for stem in stems)


def outputs(lib, phi, g, mov, fix, tile, dtype=torch.float32) -> dict:
    """``{kernel: output}`` of each kernel of ``lib`` for ``dtype``: the
    float32 inputs ``phi``, ``g`` and ``mov`` rounded to ``dtype``, ``fix``
    float32."""
    vol = tuple(mov.shape)
    suffix = ops._suffix(dtype)
    phi, g, mov = (t.to(dtype) for t in (phi, g, mov))
    out = {}
    for name, module in FORWARD.items():
        out[name + suffix] = torch.empty(vol + (3,), dtype=dtype, device="cuda")
        module.launch(phi, out[name + suffix], tile, lib=lib)
    for name, launch in (("bsi_adjoint", bsi_adjoint.launch),
                         ("bsi_adjoint_matmul", bsi_adjoint.launch_matmul)):
        out[name + suffix] = torch.empty(tuple(phi.shape), device="cuda")
        launch(g, out[name + suffix], tile, lib=lib)
    scal_ncc = torch.stack([mov.float().mean(), fix.mean()])
    scal_nmi = torch.stack([mov.min().float(), mov.max().float(), fix.min(), fix.max()])
    for form in bsi_fused.DISP_FORMS:
        walk = bsi_fused.moment_blocks(tile, vol, form).tiles
        kw = dict(disp_form=form, lib=lib)

        def name(kind):
            return ops._fused_name(kind, form, dtype)

        out[name("ssd")] = bsi_fused.launch("ssd", phi, mov, fix, tile, walk, **kw)
        out[name("stats")] = bsi_fused.launch("stats", phi, mov, None, tile, walk, **kw)
        out[name("ncc")] = bsi_fused.launch("ncc", phi, mov, fix, tile, walk, scal=scal_ncc,
                                            **kw)
        blocks = bsi_fused.block_tiles(tile, form, bsi_fused.nmi_smem_bytes(32))
        out[name("nmi")] = bsi_fused.launch(
            "nmi", phi, mov, fix, tile, blocks, scal=scal_nmi, bins=32, sigma=0.5 / 31,
            eps=1e-8, **kw)
        own, extra = bsi_fused.lncc_blocks(tile, 9, form, vol)
        out[name("lncc")] = bsi_fused.launch(
            "lncc", phi, mov, fix, tile, own, eps=1e-5, window=9, extra=extra, **kw)
    torch.cuda.synchronize()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="LIB", required=True,
                    help="the other build's library (.so)")
    ap.add_argument("--shape", type=int, nargs=3, default=PAPER_VOLUMES["phantom1"])
    ap.add_argument("--tile", type=int, nargs=3, default=(5, 5, 5))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_builds: needs a CUDA device")
    vol, tile = tuple(args.shape), tuple(args.tile)
    tensors = inputs(vol, tile)
    libs = load_library(), Library(BuildInfo(Path(args.against), 0.0, ()))
    equal, compared, skipped = {}, [], []
    for dtype in bsi_ttli.ENTRY_SUFFIX:
        if not all(exports(lib, dtype) for lib in libs):
            skipped.append(str(dtype).removeprefix("torch."))
            continue
        compared.append(str(dtype).removeprefix("torch."))
        this, other = (outputs(lib, *tensors, tile, dtype) for lib in libs)
        equal.update({name: bool(torch.equal(this[name], other[name])) for name in this})
        del this, other
    print(f"card: {card_name()}; volume {vol}, tile {tile}; against {args.against}")
    print(f"dtypes compared: {', '.join(compared) or 'none'}; skipped (a build lacks "
          f"their entry points): {', '.join(skipped) or 'none'}")
    for name, same in equal.items():
        print(f"{name}: bit-equal {same}")
    print(json.dumps({"against": args.against, "compared": compared, "skipped": skipped,
                      "bit_equal": equal}))
    return 0 if equal and all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
