"""The port's attention and layers (what runs on the CPU) against the JAX package.

The flash-attention kernel's plain version is held against the JAX
package's ``attend_full`` oracle with the parametrization of
``tests/test_kernels_flash.py`` (2e-5 in float32; bf16 inputs against the
float32 oracle at 5e-2, as there), and against the Pallas kernel in
interpret mode where this JAX has ``pallas.load``.  The layers, the caches
and decode attention run in float32 at 1e-6.  Inputs are made with numpy
from a seed and handed to both packages.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as rattn  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro_torch.kernels import flash_attention, ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import ParamDict  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401

def _qkv(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def _oracle(q, k, v, **kw):
    """The JAX package's ``attend_full`` over positions ``arange(S)``."""
    pos = jnp.arange(q.shape[1])
    return np.asarray(rattn.attend_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        q_positions=pos, k_positions=pos, **kw))


def _plain(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return flash_attention.plain(*t, **kw)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 64, 4, 4, 16),    # MHA
    (1, 128, 8, 2, 32),   # GQA 4:1
    (2, 64, 4, 1, 16),    # MQA
    (1, 64, 4, 2, 256),   # gemma2-2b's head dim
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_oracle(B, S, H, KV, hd, causal):
    q, k, v = _qkv(B, S, H, KV, hd)
    out = _plain(q, k, v, causal=causal, block=32).numpy()
    np.testing.assert_allclose(out, _oracle(q, k, v, causal=causal), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=8),
    dict(causal=True, window=8, softcap=50.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_attend_full_matches_oracle(kw, dtype):
    """The port's unchunked ``attend_full`` against the JAX package's, GQA
    2:1 and a ragged length; bf16 inputs round as the JAX package rounds
    them (the score product in bf16), so both sides see the same bf16
    arrays and agree to bf16 rounding."""
    q, k, v = _qkv(2, 40, 4, 2, 16, seed=9)
    pos = torch.arange(40)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    out = tattn.attend_full(*t, q_positions=pos, k_positions=pos, **kw)
    assert out.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), _oracle(q, k, v, **kw), atol=2e-5,
                                   rtol=2e-5)
        return
    jpos = jnp.arange(40)
    ref = rattn.attend_full(*(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in t),
                            q_positions=jpos, k_positions=jpos, **kw)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window", [8, 32, 64, 100])  # 64 and 100: >= S
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_sliding_window(window, causal):
    q, k, v = _qkv(1, 64, 4, 4, 16, seed=1)
    out = _plain(q, k, v, causal=causal, window=window, block=16).numpy()
    ref = _oracle(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_flash_plain_softcap():
    q, k, v = _qkv(1, 32, 2, 2, 16, seed=2)
    out = _plain(q, k, v, softcap=30.0, block=16).numpy()
    ref = _oracle(q, k, v, causal=True, softcap=30.0)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_sequence(window, causal):
    """S = 40 with 16-row blocks: the last block holds 8 rows and keys."""
    q, k, v = _qkv(2, 40, 4, 2, 16, seed=3)
    out = _plain(q, k, v, causal=causal, window=window, softcap=50.0, block=16).numpy()
    ref = _oracle(q, k, v, causal=causal, window=window, softcap=50.0)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_dtypes(dtype):
    q, k, v = _qkv(1, 64, 4, 2, 16, seed=3)
    if dtype == torch.bfloat16:  # the oracle sees the same bf16-rounded inputs
        q, k, v = (torch.from_numpy(a).to(dtype).float().numpy() for a in (q, k, v))
    out = _plain(q, k, v, dtype=dtype, block=32)
    assert out.dtype == dtype
    atol = 2e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(out.float().numpy(), _oracle(q, k, v), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("block", [16, 64, 256])
def test_flash_plain_block_changes_only_rounding(block):
    """Skipping key blocks left of the window and past the diagonal is exact
    up to rounding, whatever the block."""
    q, k, v = _qkv(1, 72, 4, 2, 32, seed=4)
    out = _plain(q, k, v, window=20, softcap=50.0, block=block).numpy()
    ref = _oracle(q, k, v, causal=True, window=20, softcap=50.0)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=16),
    dict(causal=True, softcap=30.0)])
def test_flash_plain_matches_pallas_kernel(kw):
    from jax.experimental import pallas as pl

    if not hasattr(pl, "load"):
        pytest.skip("this JAX's pallas has no `load`, which the JAX package's "
                    "flash kernel calls")
    from repro.kernels.flash_attention import flash_attention_pallas

    q, k, v = _qkv(1, 64, 4, 2, 16, seed=5)
    ref = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), block_q=16, block_kv=16,
                                            interpret=True, **kw))
    np.testing.assert_allclose(_plain(q, k, v, block=16, **kw).numpy(), ref, atol=2e-5,
                               rtol=2e-5)


def test_attend_blockwise_on_the_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 48, 4, 2, 16, seed=6))
    ops.reset_launch_counts()
    out = tattn.attend_blockwise(q, k, v, window=8, softcap=50.0)
    assert torch.equal(out, flash_attention.plain(q, k, v, window=8, softcap=50.0))
    assert ops.launch_counts()["flash_attention"] == 0
    ref = _oracle(*(t.numpy() for t in (q, k, v)), causal=True, window=8, softcap=50.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_flash_dispatcher_refuses_mismatched_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="k and v"):
        ops.flash_attention(q, k[:, :8], v[:, :8])
    with pytest.raises(ValueError, match="key/value heads"):
        ops.flash_attention(q[:, :, :3], k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_p_dtype_none_is_the_float32_product(dtype):
    """``p_dtype=None`` is the default and keeps the function bit for bit;
    the bf16 twin rounds otherwise."""
    import inspect

    assert inspect.signature(flash_attention.plain).parameters["p_dtype"].default is None
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(2, 100, 4, 2, 32, seed=7))
    kw = dict(window=24, softcap=30.0, block=32)
    ref = flash_attention.plain(q, k, v, **kw)
    assert torch.equal(flash_attention.plain(q, k, v, p_dtype=None, **kw), ref)
    np.testing.assert_allclose(ref.float().numpy(), _oracle(
        *(t.float().numpy() for t in (q, k, v)), window=24, softcap=30.0),
        atol=2e-5 if dtype == torch.float32 else 5e-2, rtol=2e-5)
    assert not torch.equal(flash_attention.plain(q, k, v, p_dtype=torch.bfloat16, **kw),
                           ref)


# The card tests' cases (tests/test_torch_cuda.py: FLASH_SHAPES, FLASH_MASKS)
TWIN_SHAPES = [(2, 128, 4, 4, 16), (1, 200, 8, 2, 64), (2, 96, 4, 1, 128),
               (1, 330, 8, 4, 256)]
TWIN_MASKS = [dict(causal=True), dict(causal=False), dict(causal=True, window=40),
              dict(causal=False, window=40), dict(causal=True, softcap=50.0),
              dict(causal=True, window=64, softcap=30.0)]


@pytest.mark.parametrize("mask", TWIN_MASKS, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("shape", TWIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_bf16_rounding_twin_within_derived_bound(shape, mask):
    """The bf16 kernel's rounding twin (``p`` rounded to bf16 for PV, at the
    kernel's 64-key blocks) against the TPU kernel's function (float32 ``p``),
    on bf16 inputs: within ``2^-7 max(|o|, |r|) + 2^-8 max|v| + 1e-5``, the
    bound the card tests hold the kernel to.  ``2^-8 max|v|`` bounds
    ``|sum p_i d_i v_i| / l`` for rounding errors ``|d_i| <= 2^-8``; the
    first term is one bf16 step of the outputs."""
    B, S, H, KV, hd = shape
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(B, S, H, KV, hd))
    twin = flash_attention.plain(q, k, v, block=flash_attention.KEY_BLOCK,
                                 p_dtype=torch.bfloat16, **mask).float()
    ref = flash_attention.plain(q, k, v, **mask).float()
    bound = (2.0**-7 * torch.maximum(twin.abs(), ref.abs())
             + 2.0**-8 * v.float().abs().max() + 1e-5)
    assert ((twin - ref).abs() <= bound).all(), (twin - ref).abs().max().item()
    assert not torch.equal(twin, ref)  # the rounding is there to bound


def test_flash_key_range():
    kr = flash_attention.key_range
    assert kr(128, 192, 500, causal=True, window=0, block=64) == (0, 192)
    assert kr(128, 192, 150, causal=True, window=0, block=64) == (0, 150)
    assert kr(128, 192, 500, causal=True, window=40, block=64) == (64, 192)
    assert kr(128, 192, 500, causal=False, window=40, block=64) == (64, 500)
    assert kr(0, 64, 500, causal=True, window=4096, block=64) == (0, 64)


# ------------------------------------------------------------------ layers

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    ref = np.asarray(rlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    out = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (256, 10_000.0), (64, 1e6)])
def test_rope_matches_reference(hd, theta):
    """1e-6, plus what one float32 rounding of a frequency makes of the
    angle: XLA's float32 ``exp`` is off the correctly rounded value by an ulp
    for 15 of the 128 frequencies at head dim 256 (torch's for 3), and the
    angle carries that ulp times the position."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 48, 4, hd)).astype(np.float32)
    pos = np.arange(48)
    ref = np.asarray(rlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    out = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    half = hd // 2
    pair = np.abs(x[..., :half]) + np.abs(x[..., half:])
    bound = 1e-6 + pos[:, None, None] * 2.0**-23 * np.concatenate([pair, pair], -1)
    assert (np.abs(out - ref) <= bound).all(), np.abs(out - ref).max()
    if hd < 256:  # every frequency rounds alike in both
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    # one decode position, broadcast over the batch
    ref1 = np.asarray(rlayers.rope(jnp.asarray(x[:, :1]), jnp.asarray([37]), theta))
    out1 = tlayers.rope(torch.from_numpy(x[:, :1]), torch.tensor([37]), theta).numpy()
    np.testing.assert_allclose(out1, ref1, atol=1e-6, rtol=1e-6)


def _params(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) / math.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


def _module(params):
    return ParamDict({k: torch.from_numpy(v) for k, v in params.items()})


def test_glu_mlp_matches_reference():
    p = _params({"wi_gate": (64, 128), "wi_up": (64, 128), "wo": (128, 64)}, 2)
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    ref = np.asarray(rlayers.glu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x)))
    out = tlayers.glu_mlp(_module(p), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_project_qkv_matches_reference(bias):
    d, H, KV, hd = 64, 4, 2, 16
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd)}
    if bias:
        shapes.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    p = _params(shapes, 4)
    x = np.random.default_rng(5).standard_normal((2, 12, d)).astype(np.float32)
    pos = np.arange(3, 15)
    ref = rattn.project_qkv({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                            jnp.asarray(pos), n_heads=H, n_kv=KV)
    out = tattn.project_qkv(_module(p), torch.from_numpy(x), torch.from_numpy(pos),
                            n_heads=H, n_kv=KV)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- KV caches

class _Cfg:
    """The fields ``cache_schema_shapes`` reads."""

    def __init__(self, kv_cache_dtype):
        self.resolved_head_dim, self.num_layers, self.num_kv_heads = 16, 1, 2
        self.kv_cache_dtype = kv_cache_dtype


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_update_and_read_cache_match_reference(kv_dtype):
    cfg = _Cfg(kv_dtype)
    rng = np.random.default_rng(6)
    k_new, v_new = (rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
                    for _ in range(2))
    quant = kv_dtype == "int8"
    ref = {n: a[0] for n, a in rattn.init_cache(cfg, 2, 8).items() if n != "pos"}
    ref = rattn.update_cache(ref, jnp.asarray(k_new), jnp.asarray(v_new), 4, quant)
    out = {n: t[0] for n, t in tattn.init_cache(cfg, 2, 8, device="cpu").items() if n != "pos"}
    tattn.update_cache(out, torch.from_numpy(k_new), torch.from_numpy(v_new), 4, quant)
    for name in ref:
        np.testing.assert_array_equal(out[name].float().numpy(),
                                      np.asarray(ref[name]).astype(np.float32))
    for a, b in zip(tattn.read_cache(out, torch.float32),
                    rattn.read_cache(ref, jnp.float32)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 50.0), (3, 0.0)])
def test_decode_attend_matches_reference(window, softcap):
    q, _, _ = _qkv(2, 1, 4, 2, 16, seed=7)
    _, k, v = _qkv(2, 20, 4, 2, 16, seed=8)
    kw = dict(q_pos=12, cache_len=13, window=window, softcap=softcap)
    ref = np.asarray(rattn.decode_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         **{**kw, "q_pos": jnp.asarray(12),
                                            "cache_len": jnp.asarray(13)}))
    out = tattn.decode_attend(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
