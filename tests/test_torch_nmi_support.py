"""The fused nmi kernel's arithmetic that runs on the CPU: its truncated
Parzen support, the stride of its staged weights, its shared memory, its
3xTF32 split and its FMA-corrected divisions (in exact arithmetic: for
every float32 numerator at the default sigma, on samples otherwise).

Pure arithmetic on float32 values and shapes, so it runs on the CPU: the
kernel itself runs only on the card (``tests/test_torch_cuda.py``).  The kernel
evaluates a value's Gaussian weights only at the bins within
``kernels.bsi_fused.nmi_support`` of the nearest centre
(``nmi_support_range``); every weight outside must be exactly 0.0f in the
untruncated computation (here with torch's expf), so that skipping it
changes no float.
"""

import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.similarity import parzen_centres, parzen_weights  # noqa: E402
from repro_torch.kernels import bsi_fused, bsi_ttli  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
BINS = [2, 10, 16, 32, 64]
SIGMA_RATIOS = [0.25, 0.5, 1.0, 2.0]
EPS = 1e-8  # nmi()'s default
TILE = (5, 5, 5)
PHANTOM1 = [(512, 228, 385), (256, 114, 193)]  # and its coarse level
THREE_BLOCKS_SMEM_BYTES = 233_472 // 3 - 1024  # 228 KB an SM, 1 KB reserved a block


def _values():
    """[0, 1] densely, both ends, and one float32 ulp outside each."""
    x = torch.linspace(0.0, 1.0, 20_001, dtype=torch.float32)
    one, zero = torch.tensor(1.0), torch.tensor(0.0)
    ends = torch.stack([zero, one, torch.nextafter(zero, -one),
                        torch.nextafter(one, 2 * one)])
    return torch.cat([x, ends])


def _weights(bins, sigma_ratio):
    """The values, the centres, sigma as ``nmi()`` makes it, the plain
    weights and the kernel's support mask ``(V, bins)``."""
    x = _values()
    centres = parzen_centres(bins, "cpu")
    sigma = x.new_full((), sigma_ratio / (bins - 1))  # a Python double, in float32
    w = parzen_weights(x, centres, sigma, EPS)
    lo, hi = bsi_fused.nmi_support_range(x, bins, bsi_fused.nmi_support(bins, sigma_ratio))
    k = torch.arange(bins)[None, :]
    inside = (k >= lo[:, None]) & (k <= hi[:, None])
    return x, centres, sigma, w, inside


def test_support_half_width():
    """8 bins at the default sigma of half a bin (the sweep below reaches 7),
    clipped to the bins; the least K with K - 1/2 > sqrt(208) sigma_ratio."""
    assert bsi_fused.nmi_support(32, 0.5) == 8
    assert bsi_fused.nmi_support(2, 0.5) == 1
    assert bsi_fused.nmi_support(64, 2.0) == 30
    assert bsi_fused.nmi_support(16, 2.0) == 15
    for r in (0.01, 0.25, 0.3, 0.5, 0.7, 1.0, 1.5, 2.0):
        k = bsi_fused.nmi_support(1000, r)
        assert k - 0.5 > math.sqrt(208) * r >= k - 1.5


@pytest.mark.parametrize("sigma_ratio", SIGMA_RATIOS)
@pytest.mark.parametrize("bins", BINS)
def test_parzen_weights_vanish_outside_the_support(bins, sigma_ratio):
    x, _, _, w, inside = _weights(bins, sigma_ratio)
    assert torch.isfinite(w).all()
    assert (w[~inside] == 0).all()
    # the support is no wider than the half-width each side of the nearest
    widths = inside.sum(dim=1)
    assert widths.max().item() <= min(bins, 2 * bsi_fused.nmi_support(bins, sigma_ratio) + 1)


@pytest.mark.parametrize("sigma_ratio", SIGMA_RATIOS)
@pytest.mark.parametrize("bins", BINS)
def test_truncated_weights_equal_the_untruncated_bit_for_bit(bins, sigma_ratio):
    """The kernel's truncated weights, in torch: exactly zero outside the
    support, the plain formula inside.  With the row sum in increasing k (the
    kernel's order) they equal the untruncated weights summed in that order
    bit for bit; with the row sum of ``parzen_weights`` (``torch.sum``) they
    equal ``parzen_weights`` bit for bit.  The two sum orders differ by a few
    float32 ulps of the sum (8 at most here), as the kernel always has."""
    x, centres, sigma, w, inside = _weights(bins, sigma_ratio)
    d = (x[:, None] - centres[None, :]) / sigma
    e_full = torch.exp(-0.5 * d**2)
    e_trunc = torch.where(inside, e_full, torch.zeros(()))

    def k_order(e):
        s = torch.zeros(e.shape[0])
        for k in range(bins):
            s = s + e[:, k]
        return e / (s[:, None] + EPS)

    assert torch.equal(e_trunc, e_full)
    assert torch.equal(k_order(e_trunc), k_order(e_full))
    plain_order = e_trunc / (torch.sum(e_trunc, dim=1, keepdim=True) + EPS)
    assert torch.equal(plain_order, w)
    rel = (k_order(e_trunc) - w).abs() / w.abs().clamp_min(1e-30)
    assert rel.max().item() <= 8 * 2.0**-23


def test_support_of_a_nan_is_every_bin():
    lo, hi = bsi_fused.nmi_support_range(torch.tensor([float("nan"), 0.5, -3.0, 7.0]),
                                         32, 8)
    assert lo.tolist() == [0, 8, 0, 23] and hi.tolist() == [31, 24, 8, 31]


def test_staged_weights_fragment_loads_hit_distinct_banks():
    """mma.m16n8k8 fragments: lane l reads row g = l // 4 (+ 8) and column t
    = l % 4 (+ 4) of a bin-major block of 8 voxels; with the stride 4 mod
    32 the 32 lanes of every load fall on 32 banks.  The weights stage's
    stores, the lanes at 32 consecutive voxels of one row, do too."""
    S = bsi_fused.NMI_STRIDE
    assert S % 32 == 4 and S >= bsi_fused.NMI_CHUNK
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for bp in (32, 64):
        for ks in range(bsi_fused.NMI_CHUNK // 8):
            for row0 in range(0, bp, 8):  # A's row halves and B's column tiles
                for dk in (0, 4):
                    banks = ((row0 + g) * S + ks * 8 + t + dk) % 32
                    assert len(set(banks.tolist())) == 32
    for k in range(64):
        for v0 in range(0, bsi_fused.NMI_CHUNK, 32):
            assert len(set(((k * S + v0 + lanes) % 32).tolist())) == 32


@pytest.mark.parametrize("bins", [2, 10, 16, 32, 64])
def test_nmi_shared_memory_mirrors_the_kernel(bins):
    """csrc nmi_extra_floats: 64 centres, then for each of the two teams the
    two (bp, stride) weight matrices of a round of 64 voxels; the teams' two
    (bp, bp) partial histograms fit in their place."""
    bp = 32 if bins <= 32 else 64
    assert bsi_fused.nmi_padded_bins(bins) == bp
    floats = 64 + 2 * 2 * bp * bsi_fused.NMI_STRIDE
    assert 2 * bp * bp <= floats - 64
    assert bsi_fused.nmi_smem_bytes(bins) == 4 * floats


@pytest.mark.parametrize("form", bsi_fused.DISP_FORMS)
@pytest.mark.parametrize("vol", PHANTOM1)
@pytest.mark.parametrize("bins", [32, 64])
def test_nmi_shared_memory_fits_phantom1_blocks(vol, form, bins):
    """At phantom1 and its coarse level the displacement staging plus the
    nmi kernel's shared memory fits a block in both forms; at 32 bins three
    blocks share an SM (four in the lerp form)."""
    blocks = bsi_fused.block_tiles(TILE, form, bsi_fused.nmi_smem_bytes(bins))
    smem = bsi_fused._disp_smem_bytes(TILE, blocks, form) + bsi_fused.nmi_smem_bytes(bins)
    assert smem <= bsi_ttli.MAX_SMEM_BYTES
    if bins <= 32:
        assert smem <= THREE_BLOCKS_SMEM_BYTES
        assert form == "matmul" or smem <= 233_472 // 4 - 1024
    assert bsi_fused.num_partials(vol, TILE, blocks) >= 2 * 132


def _tf32_rna(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away
    from zero (the low 13 bits cleared)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x1000) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def test_3xtf32_split_keeps_float32_products():
    """hi = rna(x), lo = rna(x - hi): hi + lo holds x to 2^-21 and
    hi hi' + hi lo' + lo hi' a product of two weights to 2^-20, well inside
    the histogram's 1e-5 of its largest cell."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, 100_000).astype(np.float32)
    b = rng.uniform(0, 1, 100_000).astype(np.float32)
    a[:5] = [0.0, 1.0, 1e-30, 0.5, 2.0**-20]

    def split(x):
        hi = _tf32_rna(x)
        return hi, _tf32_rna((x - hi).astype(np.float32))

    (ah, al), (bh, bl) = split(a), split(b)
    assert np.all(np.abs((ah.astype(np.float64) + al) - a) <= 2.0**-21 * np.abs(a))
    exact = a.astype(np.float64) * b
    three = (ah.astype(np.float64) * bh + ah.astype(np.float64) * bl
             + al.astype(np.float64) * bh)
    assert np.all(np.abs(three - exact) <= 2.0**-20 * exact)


def _rn32(q):
    """A rational rounded to the nearest float32, ties to even."""
    f = np.float32(float(q))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        err = abs(Fraction(float(c)) - q)
        key = (err, int(np.float32(c).view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1]


@pytest.mark.parametrize("bins,sigma_ratio", [(32, 0.5), (10, 0.25), (64, 2.0), (2, 1.0)])
def test_markstein_quotient_is_the_true_division(bins, sigma_ratio):
    """The kernel divides x - c by sigma as q0 = x r, q = q0 + (x - q0
    sigma) r (two FMAs) with r = 1/sigma correctly rounded.  In exact
    arithmetic, rounded as the card rounds each step, q is the correctly
    rounded x / sigma for every tested value whose square does not underflow
    (|q| >= 2^-75), so the weight expf(-q^2/2) is the true division's."""
    rng = np.random.default_rng(bins)
    centres = parzen_centres(bins, "cpu").numpy()
    sigma = np.float32(sigma_ratio / (bins - 1))
    x = np.concatenate([rng.uniform(0, 1, 300), rng.uniform(-1e-6, 1e-6, 20),
                        [0.0, 1.0, 0.5, 1e-30, 2.0**-20, 1 - 2.0**-24]]).astype(np.float32)
    n = (x[:, None] - centres[None, :]).reshape(-1)  # float32 differences
    n = n[np.abs(n.astype(np.float64) / sigma) >= 2.0**-75][:4000]
    r = _rn32(1 / Fraction(float(sigma)))
    for v in n:
        q0 = _rn32(Fraction(float(v)) * Fraction(float(r)))
        rem = _rn32(Fraction(float(v)) - Fraction(float(q0)) * Fraction(float(sigma)))
        q = _rn32(Fraction(float(rem)) * Fraction(float(r)) + Fraction(float(q0)))
        assert q == np.float32(v / sigma), (v, sigma, q)


@pytest.mark.parametrize("bins,sigma_ratio", [(32, 0.5), (10, 0.25), (64, 2.0)])
def test_markstein_normalisation_is_the_true_division(bins, sigma_ratio):
    """The kernel normalises a weight e >= 2^-100 as q0 = e r, q = q0 + (e -
    q0 den) r with r = 1/den correctly rounded (den = the row sum + eps,
    within [2^-20, 2^20]), the smaller ones by the true division: q is the
    correctly rounded e / den, checked in exact arithmetic on the weights of
    values across [0, 1]."""
    rng = np.random.default_rng(bins + 1)
    centres = parzen_centres(bins, "cpu")
    sigma = torch.tensor(sigma_ratio / (bins - 1), dtype=torch.float32)
    x = torch.from_numpy(rng.uniform(0, 1, 200).astype(np.float32))
    e = torch.exp(-0.5 * ((x[:, None] - centres[None, :]) / sigma) ** 2)
    den = (torch.sum(e, dim=1) + EPS).numpy()
    assert np.all((den >= 2.0**-20) & (den <= 2.0**20))
    e = e.numpy()
    pairs = [(ev, d) for row, d in zip(e, den) for ev in row if ev >= 2.0**-100]
    assert len(pairs) > 1000 and min(p[0] for p in pairs) < 2.0**-90
    pairs.sort()  # the smallest weights, nearest the threshold, included
    for ev, d in pairs[::max(1, len(pairs) // 3000)]:
        r = _rn32(1 / Fraction(float(d)))
        q0 = _rn32(Fraction(float(ev)) * Fraction(float(r)))
        rem = _rn32(Fraction(float(ev)) - Fraction(float(q0)) * Fraction(float(d)))
        q = _rn32(Fraction(float(rem)) * Fraction(float(r)) + Fraction(float(q0)))
        assert q == np.float32(ev / d), (ev, d, q)


def test_markstein_division_by_the_default_sigma_for_every_numerator():
    """At the default sigma, 0.5 / 31 in float32, the kernel's quotient
    (x - c) / sigma (q0 = n r, q = q0 + (n - q0 sigma) r, each step rounded
    to float32) is the true division's for every float32 numerator n whose
    weight expf(-q^2 / 2) is neither exactly 1 nor exactly 0 (|q| in [2^-14,
    16]; the sign is symmetric).  Markstein's theorem alone does not show it:
    q0 = n r is not always within an ulp of n / sigma.  Emulated in float64,
    where q0 sigma and n - q0 sigma are exact and only a sum that lands on a
    float32 midpoint can round twice (redone exactly)."""
    sigma = np.float32(0.5 / 31)
    r = np.float32(1) / sigma  # correctly rounded, as __frcp_rn
    s64, r64 = np.float64(sigma), np.float64(r)
    lo = int(np.float32(sigma * np.float32(2.0**-14)).view(np.uint32))
    hi = int(np.float32(sigma * np.float32(16)).view(np.uint32))
    checked = 0
    for start in range(lo, hi + 1, 1 << 22):
        n = np.arange(start, min(start + (1 << 22), hi + 1), dtype=np.uint32).view(np.float32)
        q0 = n * r
        rem = (n.astype(np.float64) - q0.astype(np.float64) * s64).astype(np.float32)
        t = rem.astype(np.float64) * r64 + q0.astype(np.float64)
        q = t.astype(np.float32)
        for i in np.nonzero((t.view(np.uint64) & np.uint64((1 << 29) - 1))
                            == np.uint64(1 << 28))[0]:
            q[i] = _rn32(Fraction(float(rem[i])) * Fraction(float(r))
                         + Fraction(float(q0[i])))
        wrong = np.nonzero(q != n / sigma)[0]
        assert wrong.size == 0, (n[wrong[:5]], q[wrong[:5]])
        checked += n.size
    assert checked > 1.4e8
