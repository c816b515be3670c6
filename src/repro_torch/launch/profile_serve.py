"""Where the time of the port's serving path goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch gemma2-2b]
        [--batch 4] [--prompt-len 8160] [--gen 32] [--steps 4] [--top 15]

Builds the kernels, makes the model (the port's init, seed 0) and prompts
from a seeded generator, runs one warm-up ``generate``, then traces one
prefill and ``--steps`` decode steps (on a cache of ``prompt-len + gen + 1``
positions) under ``torch.profiler``, printing for each the wall time, the
device time per kernel name, the flash-attention kernel's share and the
device's busy and idle share.  The last line is one JSON object with the
same numbers.  Needs a CUDA device; there is no CPU path.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.base import get_config
from repro_torch.device import card_name, device_ms_by_name, traced
from repro_torch.kernels.build import load_library
from repro_torch.launch.serve import generate, make_generate_steps
from repro_torch.models import model as M


def _summary(name, prof, wall, top):
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    # the bf16 (wgmma) and float32 (mma.sync 3xTF32) flash kernels
    flash = sum(t for n, t in by_name.items()
                if "flash_sm90_kernel" in n or "flash_tf32_kernel" in n)
    print(f"{name} (traced): wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / (wall * 1e3):.1%}), flash_attention kernel {flash:.1f} ms")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    for kernel, ms in ranked:
        print(f"  {ms:10.2f} ms  {kernel[:110]}")
    return dict(wall_ms=wall * 1e3, busy_ms=busy, flash_ms=flash, top=ranked)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8160)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4, help="decode steps traced")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")

    card = card_name()
    build_s = load_library().info.seconds
    cfg = get_config(args.arch)
    model = M.init_model(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device="cuda")
    max_len = args.prompt_len + args.gen + 1
    prefill, decode = steps = make_generate_steps(cfg, model, max_len)
    generate(cfg, model, prompts, max_len, args.gen, steps=steps)  # warm-up
    torch.cuda.synchronize()
    traced(lambda: torch.ones(1, device="cuda").sum().item())  # profiler start-up

    out = {}

    def run_prefill():
        out["logits"], out["cache"] = prefill({"tokens": prompts})
        torch.cuda.synchronize()

    prof, wall = traced(run_prefill)
    print(f"card: {card}; {cfg.name}, batch {args.batch}, prompt {args.prompt_len}, "
          f"{cfg.dtype}, cache {cfg.kv_cache_dtype}; kernel build {build_s:.2f} s")
    result = {"prefill": _summary("prefill", prof, wall, args.top)}
    tok = torch.argmax(out["logits"], -1)[:, None]

    def run_decode():
        cache = out["cache"]
        for _ in range(args.steps):
            logits, cache = decode(cache, tok)
        torch.cuda.synchronize()

    prof, wall = traced(run_decode)
    result["decode"] = _summary(f"{args.steps} decode steps", prof, wall, args.top)
    print(json.dumps({"card": card, "arch": cfg.name, "batch": args.batch,
                      "prompt_len": args.prompt_len, "decode_steps": args.steps,
                      **result}))


if __name__ == "__main__":
    main()
