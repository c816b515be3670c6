"""The float32 flash kernel's 3xTF32 arithmetic, on the CPU.

``csrc/flash_attention.cu`` forms both products, ``Q K^T`` and ``P V``, on
the tensor cores as three TF32 products, lo.hi + hi.lo + hi.hi, each operand
split into hi, its nearest TF32, and lo, the rest.  Here a float32 twin of
that arithmetic walks ``kernels.flash_attention.plain``'s blocks (32 keys, the
kernel's key block) with each product so formed, lo rounded as
``kernels.bsi_matmul.tf32_split`` rounds it, or cut to its top 19 bits as the
tensor core reads the kernel's unrounded rest.  On inputs made with numpy
from a seed, the twin is held to ``plain``, to a float64 product and to the
JAX package's ``attend_full`` within 2e-5, the float32 flash limit, at small
shapes with head dims 16 to 256, softcap 50 and 0, a window, and MQA: the
split keeps the float32 limit.  The kernel itself runs on the card only
(``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as rattn  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels.bsi_matmul import tf32_rna, tf32_split  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
KEY_BLOCK = 32  # the float32 kernel's key block


def tf32_top(x):
    """The TF32 a tensor core reads from float32 ``x``: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def kernel_split(x):
    """``(hi, lo)`` as the kernel feeds them: hi the nearest TF32 (as
    ``tf32_split``), lo the rest ``x - hi`` as the tensor core reads it."""
    hi = tf32_rna(x)
    return hi, tf32_top(x - hi)


def product3(eq, a, b, split):
    """``einsum(eq, a, b)`` as three TF32 products in float32: the small
    products lo.hi + hi.lo summed apart, then added to hi.hi."""
    ah, al = split(a)
    bh, bl = split(b)
    small = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
    return torch.einsum(eq, ah, bh) + small


def twin(q, k, v, *, causal=True, window=0, softcap=0.0, split=tf32_split):
    """``plain``'s online softmax over 32-key blocks (for query blocks of 32
    rows), both products by :func:`product3`; the softcap divides by
    multiplying with the float32 reciprocal, as the kernel does."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qf = (q * flash_attention.scale_of(hd)).reshape(B, S, KV, rep, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (t.permute(0, 2, 1, 3) for t in (k, v))
    out = torch.empty((B, KV, rep, S, hd), dtype=torch.float32)
    pos = torch.arange(S)
    inv_cap = torch.tensor(1.0 / softcap if softcap else 0.0, dtype=torch.float32)
    for q0 in range(0, S, KEY_BLOCK):
        q1 = min(S, q0 + KEY_BLOCK)
        qb = qf[:, :, :, q0:q1]
        qp = pos[q0:q1, None]
        m = torch.full(qb.shape[:-1], -math.inf)
        l = torch.zeros(qb.shape[:-1])
        acc = torch.zeros(qb.shape)
        k_lo, k_hi = flash_attention.key_range(q0, q1, S, causal=causal, window=window,
                                               block=KEY_BLOCK)
        for k0 in range(k_lo, k_hi, KEY_BLOCK):
            k1 = min(S, k0 + KEY_BLOCK)
            s = product3("bgrqd,bgkd->bgrqk", qb, kf[:, :, k0:k1], split)
            if softcap:
                s = torch.tanh(s * inv_cap) * softcap
            kp = pos[None, k0:k1]
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                ok &= kp <= qp
            if window > 0:
                ok &= kp > qp - window
            s = torch.where(ok, s, flash_attention.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + product3("bgrqk,bgkd->bgrqd", p, vf[:, :, k0:k1],
                                                   split)
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def exact(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The function in float64, unblocked."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    q, k, v = (t.double() for t in (q, k, v))
    k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S)
    ok = torch.ones((S, S), dtype=torch.bool)
    if causal:
        ok &= pos[None] <= pos[:, None]
    if window > 0:
        ok &= pos[None] > pos[:, None] - window
    s = s.masked_fill(~ok, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _qkv(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


# (B, S, H, KV, hd), mask: head dim 256 (gemma2-2b's) at softcap 50 and 0,
# ragged S; a window; MQA not causal; the small head dims
CASES = [
    ((1, 77, 4, 2, 256), dict(causal=True, softcap=50.0)),
    ((1, 77, 4, 2, 256), dict(causal=True, softcap=0.0)),
    ((2, 90, 4, 2, 128), dict(causal=True, window=20, softcap=30.0)),
    ((1, 70, 8, 1, 64), dict(causal=False, softcap=30.0)),
    ((2, 40, 4, 4, 32), dict(causal=False, window=9)),
    ((2, 64, 4, 2, 16), dict(causal=True)),
]


@pytest.mark.parametrize("split", [tf32_split, kernel_split], ids=["tf32_split", "kernel"])
@pytest.mark.parametrize("shape,mask", CASES,
                         ids=["x".join(map(str, s)) + "-" + "-".join(f"{k}{v:g}"
                              for k, v in m.items()) for s, m in CASES])
def test_tf32_twin_keeps_the_float32_limit(shape, mask, split):
    q, k, v = (torch.from_numpy(t) for t in _qkv(*shape, seed=sum(shape)))
    got = twin(q, k, v, split=split, **mask)
    ref = exact(q, k, v, **mask)
    plain = flash_attention.plain(q, k, v, **mask)
    pos = jnp.arange(shape[1])
    jax_out = np.asarray(rattn.attend_full(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                           jnp.asarray(v.numpy()), q_positions=pos,
                                           k_positions=pos, **mask))
    assert torch.isfinite(got).all()
    assert (got.double() - ref).abs().max().item() <= 2e-5
    assert (got - plain).abs().max().item() <= 2e-5
    np.testing.assert_allclose(got.numpy(), jax_out, atol=2e-5, rtol=0)
    # and plain itself, the kernel's reference on the card, within the limit
    assert (plain.double() - ref).abs().max().item() <= 2e-5


def test_tf32_products_are_exact_in_float32():
    """hi.hi and the small products: TF32 times TF32 (11 significant bits
    each) is exact in float32, so only the sums round."""
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 10)
            for _ in range(2))
    for split in (tf32_split, kernel_split):
        (xh, xl), (yh, yl) = split(x), split(y)
        for a, b in ((xh, yh), (xl, yh), (xh, yl)):
            assert torch.equal((a * b).double(), a.double() * b.double())
        # hi + lo holds x to 2^-21 of |x| (the kernel's lo cut, not rounded)
        rel = ((xh.double() + xl.double() - x.double()).abs() / x.double().abs()).max()
        assert rel.item() <= 2.0**-21
