"""Flash attention: the CUDA kernels' launch and their plain version.

The kernels replace the JAX package's Pallas kernel
``repro/kernels/flash_attention.py:flash_attention_pallas``: causal,
sliding-window, logit-softcapped GQA attention by online softmax, with the
scores, the running max and sum and the accumulator in float32.  They read
the ``(B, S, H, hd)`` and ``(B, S, KV, hd)`` layouts in place (query head
``h`` reads key/value head ``h // (H // KV)``), mask the keys past ``S`` and
write no row past ``S``, so any sequence length runs.

- bfloat16: ``csrc/flash_attention_sm90.cu``, on the tensor cores (wgmma,
  TMA, a producer and two consumer warpgroups over 128 query rows, 64-key
  blocks).  It rounds ``p`` to bf16 for the PV product, as
  ``plain(..., p_dtype=torch.bfloat16)`` does; ``l`` sums the float32 ``p``.
- float32: ``csrc/flash_attention.cu``, float32 FMAs on the CUDA cores (64
  query rows a block), ``p`` in float32 as :func:`plain`.

:func:`plain` computes the function in tensor ops, block by block over the
same key range, and ``kernels.ops.flash_attention`` picks between kernel and
plain version by the tensor's device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import load_library

__all__ = ["HEAD_DIMS", "KEY_BLOCK", "NEG_INF", "key_range", "launch", "plain",
           "scale_of"]

NEG_INF = -2.0e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the kernels are built for
# The bf16 kernel's key block, and its rows per consumer warpgroup: with
# ``block=KEY_BLOCK``, ``plain(..., p_dtype=torch.bfloat16)`` walks the same
# blocks with the same running max, so it rounds the same ``p``.
KEY_BLOCK = 64
_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


def scale_of(hd) -> float:
    """``1 / sqrt(hd)``, the factor q is scaled by (rounded to float32 at use)."""
    return 1.0 / (hd ** 0.5)


def key_range(q0, q1, S, *, causal, window, block):
    """``[k0, k1)``: the keys of the ``block``-aligned key blocks that the
    mask leaves any key in for the query rows ``[q0, q1)``; the blocks wholly
    past the diagonal (causal) or wholly left of the window are skipped."""
    k1 = min(S, q1) if causal else S
    k0 = max(0, q0 - window + 1) // block * block if window > 0 else 0
    return k0, k1


def plain(q, k, v, *, causal=True, window=0, softcap=0.0, block=256, p_dtype=None):
    """The kernels' function in tensor ops, float32 inside.

    q: ``(B, S, H, hd)``; k, v: ``(B, S, KV, hd)`` with ``H % KV == 0``;
    query and key positions are ``arange(S)``.  ``window = 0`` is full
    attention, ``softcap = 0`` no cap.  Returns ``(B, S, H, hd)`` in q's
    dtype.  Blocks of ``block`` query rows each run an online softmax over
    ``block``-key steps of :func:`key_range`, as the kernels do (masked
    scores ``NEG_INF``, the running max from ``-inf``).  ``p_dtype``: None
    multiplies the float32 probabilities by ``v``, as the TPU kernel and the
    float32 kernel do.  ``torch.bfloat16`` rounds as the bf16 kernel does:
    the scale multiplies the product ``q . k`` (not ``q``), the softcap
    divides by multiplying with its reciprocal, and the probabilities are
    rounded to bf16 for the PV product (``l`` still sums the float32 ones).
    That rounding moves each output by at most ``2^-8 * max|v|``:
    ``|sum p_i d_i v_i| / l`` with ``|d_i| <= 2^-8`` and ``l = sum p_i``.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = scale_of(hd)
    twin = p_dtype is not None
    # (B, KV, rep, S, hd): query head h = g * rep + r reads key/value head g
    qf = (q.float() if twin else q.float() * scale).reshape(
        B, S, KV, rep, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)  # (B, KV, S, hd)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty((B, KV, rep, S, hd), dtype=torch.float32, device=q.device)
    pos = torch.arange(S, device=q.device)
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        qb = qf[:, :, :, q0:q1]
        qp = pos[q0:q1, None]
        m = torch.full(qb.shape[:-1], -math.inf, device=q.device)
        l = torch.zeros(qb.shape[:-1], device=q.device)
        acc = torch.zeros(qb.shape, device=q.device)
        k_lo, k_hi = key_range(q0, q1, S, causal=causal, window=window, block=block)
        for k0 in range(k_lo, k_hi, block):
            k1 = min(S, k0 + block)
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb, kf[:, :, k0:k1])
            if twin:
                s = s * scale
            if softcap:
                s = torch.tanh(s * (1.0 / softcap) if twin else s / softcap) * softcap
            kp = pos[None, k0:k1]
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                ok &= kp <= qp
            if window > 0:
                ok &= kp > qp - window
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = p.to(p_dtype).float() if twin else p
            acc = acc * corr[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", pv,
                                                       vf[:, :, k0:k1])
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def launch(q, k, v, out, *, causal, window, softcap):
    """Launch the kernel of q's dtype on the current stream: ``(q, k, v)`` ->
    ``out``."""
    B, S, H, hd = q.shape
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
            k.shape[2], hd, int(causal), int(window), scale_of(hd), float(softcap),
            stream)
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {rc}")
