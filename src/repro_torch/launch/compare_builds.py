"""Every float32 BSI kernel of this build and of another, on the same inputs.

    PYTHONPATH=src python -m repro_torch.launch.compare_builds --against LIB
        [--shape X Y Z] [--tile D D D]

``LIB`` is another build's library, as the parent commit's: unpack a ``git
archive`` of it under ``build/``, build its kernels there
(``kernels.build.load_library`` of that tree) and pass the ``.so``.  At the
paper's phantom1 volume (512 x 228 x 385, the default), tile 5^3, 3
channels, the float32 entry point of each kernel of both libraries runs on
the same seeded inputs through this tree's launches: the four forward forms
(``bsi_ttli``, ``bsi_separable``, ``bsi_tt``, ``bsi_matmul``), both
adjoints, and the five fused variants in both displacement forms (nmi at 32
bins, lncc at window 9).  Prints a line a kernel and a JSON summary; exits
non-zero unless every output of this build equals the other's bit for bit.
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


def outputs(lib, phi, g, mov, fix, tile) -> dict:
    """``{kernel: output}`` of each float32 kernel of ``lib``."""
    vol = tuple(mov.shape)
    out = {}
    for name, module in FORWARD.items():
        out[name] = torch.empty(vol + (3,), device="cuda")
        module.launch(phi, out[name], tile, lib=lib)
    for name, launch in (("bsi_adjoint", bsi_adjoint.launch),
                         ("bsi_adjoint_matmul", bsi_adjoint.launch_matmul)):
        out[name] = torch.empty(tuple(phi.shape), device="cuda")
        launch(g, out[name], tile, lib=lib)
    scal_ncc = torch.stack([mov.mean(), fix.mean()])
    scal_nmi = torch.stack([mov.min(), mov.max(), fix.min(), fix.max()])
    for form in bsi_fused.DISP_FORMS:
        walk = bsi_fused.moment_blocks(tile, vol, form).tiles
        kw = dict(disp_form=form, lib=lib)
        out[ops._fused_name("ssd", form)] = bsi_fused.launch("ssd", phi, mov, fix, tile, walk,
                                                             **kw)
        out[ops._fused_name("stats", form)] = bsi_fused.launch("stats", phi, mov, None, tile,
                                                               walk, **kw)
        out[ops._fused_name("ncc", form)] = bsi_fused.launch("ncc", phi, mov, fix, tile, walk,
                                                             scal=scal_ncc, **kw)
        blocks = bsi_fused.block_tiles(tile, form, bsi_fused.nmi_smem_bytes(32))
        out[ops._fused_name("nmi", form)] = bsi_fused.launch(
            "nmi", phi, mov, fix, tile, blocks, scal=scal_nmi, bins=32, sigma=0.5 / 31,
            eps=1e-8, **kw)
        own, extra = bsi_fused.lncc_blocks(tile, 9, form, vol)
        out[ops._fused_name("lncc", form)] = bsi_fused.launch(
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
    this = outputs(load_library(), *tensors, tile)
    other = outputs(Library(BuildInfo(Path(args.against), 0.0, ())), *tensors, tile)
    equal = {name: bool(torch.equal(this[name], other[name])) for name in this}
    print(f"card: {card_name()}; volume {vol}, tile {tile}; against {args.against}")
    for name, same in equal.items():
        print(f"{name}: bit-equal {same}")
    print(json.dumps({"against": args.against, "bit_equal": equal}))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
