"""The port's serving path (prefill + decode) against the JAX package.

gemma2-2b's smoke config (4 layers, d 64, 4 query and 2 key/value heads,
window 8 on alternate layers, softcaps 50 and 30) with 48-token prompts, so
the window bites.  The JAX package's parameters (``init_model``, seed 0)
are carried across with ``convert.model_from_numpy``.  In float32 the prefill
logits and each decode step's logits agree at 1e-4, the cache at 1e-5, and
the greedy tokens are equal.  In bf16 both packages round at other places;
the port's logits must lie within twice the JAX package's own
bf16-to-float32 gap (measured here on the same inputs) of JAX's float32
logits.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.launch.serve import generate as ref_generate  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.training.steps import make_decode_step as ref_decode_step  # noqa: E402
from repro.training.steps import make_prefill_step as ref_prefill_step  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training.steps import _cast, make_decode_step, make_prefill_step  # noqa: E402,E501

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
ROOT = Path(__file__).resolve().parents[1]
ARCH, B, S, MAX_LEN = "gemma2-2b", 2, 48, 56


def _configs(**fields):
    ref = ref_config(ARCH, smoke=True)
    return (ref.__class__(**{**ref.__dict__, **fields}),
            dataclasses.replace(get_config(ARCH, smoke=True), **fields))


@pytest.fixture(scope="module")
def ref_params():
    return RM.init_model(ref_config(ARCH, smoke=True), seed=0)


@pytest.fixture(scope="module")
def model(ref_params):
    return model_from_numpy(get_config(ARCH, smoke=True),
                            jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")


def _cache(jax_cache):
    return cache_from_numpy(jax.tree_util.tree_map(np.asarray, jax_cache), device="cpu")


def _prompts(seed=0, n=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (B, n)).astype(np.int32)


def _run_both(ref_cfg, cfg, ref_params, model, steps=4):
    """Prefill logits, then ``steps`` decode logits (feeding JAX's greedy
    tokens to both), from each package; and both final caches."""
    toks = _prompts()
    rl, rc = jax.jit(ref_prefill_step(ref_cfg, max_len=MAX_LEN))(
        ref_params, {"tokens": jnp.asarray(toks)})
    pl, pc = make_prefill_step(cfg, model, MAX_LEN)({"tokens": torch.from_numpy(toks)})
    ref_out, out = [np.asarray(rl)], [pl.numpy()]
    ref_caches, caches = [rc], [{k: v.clone() if torch.is_tensor(v) else v
                                 for k, v in pc.items()}]
    rdec, pdec = jax.jit(ref_decode_step(ref_cfg)), make_decode_step(cfg, model)
    tok = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for _ in range(steps):
        rl, rc = rdec(ref_params, rc, jnp.asarray(tok))
        pl, pc = pdec(pc, torch.from_numpy(tok).long())
        ref_out.append(np.asarray(rl)[:, 0])
        out.append(pl.numpy()[:, 0])
        tok = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None].astype(np.int32)
    ref_caches.append(rc)
    caches.append(pc)
    return ref_out, out, ref_caches, caches


@pytest.fixture(scope="module")
def float32_runs(ref_params, model):
    return _run_both(*_configs(dtype="float32", kv_cache_dtype="float32"), ref_params,
                     model)


def test_float32_prefill_logits_match_reference(float32_runs):
    ref, out, _, _ = float32_runs
    assert out[0].shape == (B, 512)
    np.testing.assert_allclose(out[0], ref[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("when", [0, 1])  # after prefill, after 4 decode steps
def test_float32_cache_matches_reference(float32_runs, when):
    _, _, ref_caches, caches = float32_runs
    ref = _cache(ref_caches[when])
    got = caches[when]
    assert got["pos"] == ref["pos"] == S + 4 * when
    for name in ("k", "v"):
        assert got[name].shape == (4, B, MAX_LEN, 2, 16)
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("step", [1, 2, 3, 4])
def test_float32_decode_logits_match_reference(float32_runs, step):
    ref, out, _, _ = float32_runs
    np.testing.assert_allclose(out[step], ref[step], atol=1e-4, rtol=1e-4)


def test_float32_greedy_tokens_match_reference(ref_params, model):
    ref_cfg, cfg = _configs(dtype="float32", kv_cache_dtype="float32")
    toks = _prompts(1)
    ref, _ = ref_generate(ref_cfg, ref_params, toks, MAX_LEN, 8)
    ops.reset_launch_counts()
    out, cache = serve.generate(cfg, model, toks, MAX_LEN, 8)
    assert out.shape == (B, 8) and cache["pos"] == S + 8
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert not any(ops.launch_counts().values())  # the CPU runs no kernel


def test_bf16_logits_within_twice_the_reference_bf16_gap(float32_runs, ref_params,
                                                         model):
    ref32, _, ref32_caches, _ = float32_runs
    ref16, out16, ref16_caches, caches16 = _run_both(*_configs(), ref_params, model)
    for step, (r32, r16, o16) in enumerate(zip(ref32, ref16, out16)):
        gap = np.abs(r16 - r32).max()
        assert gap > 0
        assert np.abs(o16 - r32).max() <= 2 * gap, (step, np.abs(o16 - r32).max(), gap)
    # the bf16 caches, JAX's carried over as bf16: within twice JAX's own gap too
    ref16_cache = _cache(ref16_caches[-1])
    ref32_cache = _cache(ref32_caches[-1])
    for name in ("k", "v"):
        assert ref16_cache[name].dtype == caches16[-1][name].dtype == torch.bfloat16
        r32 = ref32_cache[name]
        gap = (ref16_cache[name].float() - r32).abs().max()
        assert (caches16[-1][name].float() - r32).abs().max() <= 2 * gap


def test_steps_cast_a_copy_once_and_keep_the_masters(model):
    cast = _cast(model, "bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in cast.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert _cast(cast, "bfloat16") is cast and _cast(model, "float32") is model
    assert [n for n, _ in cast.named_parameters()] == [
        n for n, _ in model.named_parameters()]


# ------------------------------------------------------------ port only

def test_prefill_then_decode_consistency(model):
    """Prefill(S tokens) then decode token S matches the forward over S + 1
    tokens (``tests/test_models_smoke.py``'s check, float32 cache)."""
    _, cfg = _configs(dtype="float32", kv_cache_dtype="float32")
    toks = torch.from_numpy(_prompts(2, S + 1)).long()
    h, aux = M.forward_train(model, {"tokens": toks}, cfg)
    assert aux == 0.0
    ref = M._logits(h[:, -1], model, cfg)
    _, cache = M.prefill(model, {"tokens": toks[:, :S]}, cfg, max_len=S + 4)
    logits, cache = M.decode_step(model, cache, toks[:, S:], cfg)
    assert cache["pos"] == S + 1
    np.testing.assert_allclose(logits[:, 0].numpy(), ref.numpy(), atol=2e-3, rtol=2e-3)


def test_decode_int8_cache_close_to_bf16(model):
    """``tests/test_models_smoke.py``'s int8-vs-bf16 cache check."""
    out = {}
    for kv in ("bfloat16", "int8"):
        _, cfg = _configs(dtype="float32", kv_cache_dtype=kv)
        cache = M.init_decode_cache(cfg, 1, 8, device="cpu")
        assert cache["k"].dtype == getattr(torch, kv)
        tokens = torch.ones((1, 1), dtype=torch.long)
        for _ in range(4):
            logits, cache = M.decode_step(model, cache, tokens, cfg)
        out[kv] = logits.numpy()
    err = np.abs(out["bfloat16"] - out["int8"]).max()
    assert err / (np.abs(out["bfloat16"]).max() + 1e-9) < 0.1


def test_decode_refuses_a_full_cache(model):
    _, cfg = _configs(dtype="float32", kv_cache_dtype="float32")
    cache = M.init_decode_cache(cfg, 1, 2, device="cpu")
    tokens = torch.ones((1, 1), dtype=torch.long)
    for _ in range(2):
        _, cache = M.decode_step(model, cache, tokens, cfg)
    with pytest.raises(ValueError, match="all written"):
        M.decode_step(model, cache, tokens, cfg)


def test_sampling_draws_from_the_generator(model):
    _, cfg = _configs(dtype="float32", kv_cache_dtype="float32")
    toks = _prompts(3)
    draws = [serve.generate(cfg, model, toks, MAX_LEN, 6, greedy=False,
                            generator=torch.Generator().manual_seed(7))[0]
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < cfg.vocab_size


@pytest.mark.parametrize("family", ["moe", "hybrid", "ssm", "encdec", "vlm"])
def test_other_families_are_not_ported(family):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), family=family)
    for call in (lambda: M.model_schema(cfg),
                 lambda: M.init_model(cfg, device="cpu"),
                 lambda: M.init_decode_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 17b"):
            call()


def test_init_model_is_seeded_by_path_not_process():
    """A leaf's values depend on the seed and its path only: the same in a
    fresh process, different for another seed or another leaf."""
    _, cfg = _configs()
    a = M.init_model(cfg, seed=0, device="cpu")
    assert torch.equal(a.blocks[1].attn.wq, M.init_model(cfg, seed=0, device="cpu")
                       .blocks[1].attn.wq)
    assert not torch.equal(a.blocks[1].attn.wq,
                           M.init_model(cfg, seed=1, device="cpu").blocks[1].attn.wq)
    assert not torch.equal(a.blocks[1].attn.wq[:16, :16], a.blocks[1].attn.wk[:16, :16])
    assert torch.equal(a.final_norm.scale, torch.ones(64))
    code = ("from repro_torch.configs.base import get_config; "
            "from repro_torch.models.model import init_model; "
            "m = init_model(get_config('gemma2-2b', smoke=True), seed=0, device='cpu'); "
            "print(repr(float(m.blocks[1].attn.wq.double().sum())))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="123")
    run = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert float(run.stdout) == float(a.blocks[1].attn.wq.double().sum())


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "20",
                "--gen", "3", "--device", "cpu", "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "on cpu" in out
