"""Batched serving: prefill + decode with a quantizable KV cache.

Usage (on the card; ``--device cpu`` runs the kernels' plain versions):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --batch 4 --prompt-len 8160 --gen 32

The port of the JAX package's ``repro/launch/serve.py``.  Greedy decoding
picks the same tokens from the same logits.  Sampling draws from an explicit
``torch.Generator``, whose random stream is not JAX's: sampled tokens are not
comparable between the two packages.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import card_name
from repro_torch.models import model as M
from repro_torch.training.steps import _cast, make_decode_step, make_prefill_step

__all__ = ["generate", "make_generate_steps", "main"]


def make_generate_steps(cfg, model, max_len):
    """The (prefill, decode) pair ``generate`` runs on, over one copy of
    ``model`` cast to ``cfg.dtype``.  Build once and pass as
    ``generate(..., steps=...)`` when timing: each ``generate`` call
    otherwise casts the model anew."""
    model = _cast(model, cfg.dtype)
    return make_prefill_step(cfg, model, max_len), make_decode_step(cfg, model)


def generate(cfg, model, prompts, max_len, gen_steps, *, greedy=True, generator=None,
             steps=None):
    """prompts: ``(B, P)`` integer tokens (a tensor or array).  Returns
    ``((B, gen_steps) generated tokens, cache)`` on the model's device.

    Greedy takes the first largest logit, as ``jnp.argmax`` does; otherwise
    each token is drawn from the softmax of its logits with ``generator``
    (``None``: PyTorch's default generator of the device).
    """
    device = model.embed.table.device
    prompts = torch.as_tensor(prompts, device=device).long()
    prefill, decode = make_generate_steps(cfg, model, max_len) if steps is None else steps
    logits, cache = prefill({"tokens": prompts})
    tok = torch.argmax(logits, -1)[:, None]
    out = []
    for _ in range(gen_steps):
        out.append(tok)
        logits, cache = decode(cache, tok)
        if greedy:
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        else:
            tok = torch.multinomial(torch.softmax(logits[:, -1], -1), 1,
                                    generator=generator)
    return torch.cat(out, dim=1), cache


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-dtype", default=None, choices=[None, "bfloat16", "int8"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
    model = M.init_model(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    max_len = args.prompt_len + args.gen + 1
    on_card = model.embed.table.is_cuda

    def timed():
        t0 = time.perf_counter()
        toks, _ = generate(cfg, model, prompts, max_len, args.gen, steps=steps)
        if on_card:
            torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    steps = make_generate_steps(cfg, model, max_len)
    toks, cold = timed()  # the first call loads and builds the kernels
    toks, dt = timed()
    n = args.batch * args.gen
    device = card_name() if on_card else "cpu"
    print(f"arch={cfg.name} kv={cfg.kv_cache_dtype} generated {n} tokens in {dt:.2f}s "
          f"({n / dt:.1f} tok/s warm; first call {cold:.2f}s) on {device}")
    print("sample:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
