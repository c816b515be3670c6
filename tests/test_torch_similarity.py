"""The port's similarity terms and metrics against the JAX package.

Values and gradients (with respect to the warped volume) at 1e-5 relative to
the largest magnitude, on numpy inputs from a seed, including volumes below
the LNCC window and volumes whose minimum and maximum are tied over many
voxels (``torch.min`` and ``jnp.min`` must both split the cotangent evenly).

Each loss gets the inputs it is built for, where its float32 gradient is
well conditioned in both packages: NCC, LNCC and SSD uniform noise (clipped
for ties), NMI a phantom against a remapped phantom (clipped, so tied at its
minimum).  The NMI gradient of two noise volumes is a flat joint histogram's
cancellation, where both packages sit about 1e-5 from float64; the NCC
gradient of two phantoms is 3e-5 from float64 in the JAX package and 4e-7
in this one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import metrics as rmetrics  # noqa: E402
from repro.core import similarity as rsim  # noqa: E402
from repro.data.volumes import make_phantom as ref_make_phantom  # noqa: E402
from repro_torch import RegistrationOptions, ffd_register, make_pair  # noqa: E402
from repro_torch.core import ffd, metrics, similarity  # noqa: E402

SHAPE = (13, 11, 9)


def _vols(seed, shape=SHAPE, ties=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = rng.uniform(0, 1, shape).astype(np.float32)
    if ties:  # clipped like make_phantom: many voxels exactly at 0 and at 1
        a = np.clip(a * 1.6 - 0.3, 0.0, 1.0).astype(np.float32)
        b = np.clip(b * 1.4 - 0.2, 0.0, 1.0).astype(np.float32)
    return a, b


def _phantoms(seed, shape=SHAPE):
    """A phantom and a remapped phantom: a synthetic multi-modal pair."""
    a = np.array(ref_make_phantom(shape, seed=seed))
    b = np.array(ref_make_phantom(shape, seed=seed + 4))
    return a, ((1.0 - b) ** 1.5).astype(np.float32)


LOSSES = [
    ("ncc", lambda m: m.ncc_loss, _vols),
    ("lncc", lambda m: m.lncc(), _vols),
    ("lncc5", lambda m: m.lncc(5), _vols),
    ("ssd", lambda m: m.ssd, _vols),
    ("nmi", lambda m: m.nmi(), _phantoms),
    ("nmi16", lambda m: m.nmi(bins=16), _phantoms),
]


@pytest.mark.parametrize("shape,ties", [(SHAPE, False), (SHAPE, True),
                                        ((4, 4, 4), False), ((12, 10, 4), True)])
@pytest.mark.parametrize("name,pick,inputs", LOSSES, ids=[n for n, _, _ in LOSSES])
def test_loss_value_and_gradient_match_reference(name, pick, inputs, shape, ties):
    if inputs is _vols:
        a, b = _vols(1, shape, ties)
    else:  # phantoms are always tied at their minimum
        a, b = _phantoms(1 if ties else 2, shape)
        assert (a == a.min()).sum() > 1
    ref_fn, fn = pick(rsim), pick(similarity)
    ref_v, ref_g = jax.value_and_grad(ref_fn)(jnp.asarray(a), jnp.asarray(b))
    ref_g = np.asarray(ref_g)
    w = torch.from_numpy(a).requires_grad_(True)
    v = fn(w, torch.from_numpy(b))
    (g,) = torch.autograd.grad(v, w)
    assert v.dtype == torch.float32 and v.dim() == 0
    assert abs(v.item() - float(ref_v)) <= 1e-5 * max(abs(float(ref_v)), 1e-3)
    assert np.abs(g.numpy() - ref_g).max() <= 1e-5 * np.abs(ref_g).max()


def test_min_max_ties_split_the_gradient_like_jax():
    x = np.array([0.0, 0.0, 0.5, 1.0, 1.0, 1.0], np.float32)
    ref = np.asarray(jax.grad(lambda v: jnp.min(v) + 2.0 * jnp.max(v))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.min(t) + 2.0 * torch.max(t), t)
    np.testing.assert_allclose(g.numpy(), ref, atol=1e-7)
    assert ref[0] == 0.5 and abs(ref[3] - 2.0 / 3.0) < 1e-7


@pytest.mark.parametrize("name", ["ncc", "nmi"])
def test_warp_gradient_with_ties_matches_jax(name):
    """Through the warp, as the level step differentiates it: a clipped
    volume at ``phi = 0`` (clamp ties and min/max ties together)."""
    from repro.core import ffd as rffd

    mov, fix = (_vols(2, SHAPE, ties=True) if name == "ncc" else _phantoms(3))
    disp = np.zeros(SHAPE + (3,), np.float32)
    ref_fn = rsim.resolve_similarity(name)[1]
    ref = np.asarray(jax.grad(
        lambda d: ref_fn(rffd.warp_volume(jnp.asarray(mov), d), jnp.asarray(fix)))(
            jnp.asarray(disp)))
    d = torch.from_numpy(disp).requires_grad_(True)
    fn = similarity.resolve_similarity(name)[1]
    loss = fn(ffd.warp_volume(torch.from_numpy(mov), d), torch.from_numpy(fix))
    (g,) = torch.autograd.grad(loss, d)
    assert np.abs(ref).max() > 0
    assert np.abs(g.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("size", [1, 3, 9, 20])
def test_uniform_filter_matches_reference(size):
    a, _ = _vols(3)
    ref = np.asarray(rsim.uniform_filter(jnp.asarray(a), size))
    out = similarity.uniform_filter(torch.from_numpy(a), size).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("shape", [SHAPE, (4, 4, 4)])
def test_metrics_match_reference(shape):
    a, b = _vols(4, shape, ties=True)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(metrics.mae(at, bt).item() - float(rmetrics.mae(a, b))) <= 1e-6
    for x, y in ((a, b), (a, a)):
        ref = float(rmetrics.ssim(jnp.asarray(x), jnp.asarray(y)))
        out = metrics.ssim(torch.from_numpy(x), torch.from_numpy(y)).item()
        assert abs(out - ref) <= 1e-5


def test_registry_and_factories():
    assert {"ssd", "ncc", "lncc", "nmi"} <= set(similarity.available_similarities())
    assert similarity.nmi(bins=48) is similarity.nmi(48, 0.5, 1e-8)
    assert similarity.lncc(window=5) is similarity.lncc(5.0, 1e-5)
    assert similarity.nmi(bins=48) is not similarity.nmi(bins=32)
    assert similarity.resolve_similarity(similarity.nmi())[0] == "nmi"
    for name in ("ssd", "ncc", "lncc", "nmi"):
        fn = similarity.resolve_similarity(name)[1]
        spec = similarity.fused_spec(name)
        assert similarity._loss_from_spec(spec) is fn
        assert spec == rsim.fused_spec(name)
    for fn in (similarity.nmi(bins=48), similarity.lncc(window=5, eps=1e-4)):
        ref = rsim.nmi(bins=48) if "nmi" in fn.__qualname__ else rsim.lncc(5, 1e-4)
        assert similarity.similarity_token(fn) == rsim.similarity_token(ref)
    with pytest.raises(ValueError, match="unknown similarity"):
        similarity.resolve_similarity("nosuch")
    with pytest.raises(ValueError, match="bins"):
        similarity.nmi(bins=1)


def test_register_similarity_round_trip():
    @similarity.register_similarity("test_mae")
    def mae_loss(w, f):
        return torch.mean(torch.abs(w - f))

    try:
        assert similarity.resolve_similarity("test_mae") == ("test_mae", mae_loss)
        assert similarity.fused_spec("test_mae") is None
    finally:
        similarity.SIMILARITIES._entries.pop("test_mae")


def test_multimodal_nmi_beats_ssd():
    """Known FFD warp + monotone intensity remap: ``similarity="nmi"`` lands a
    lower post-registration MAE than SSD (which chases the inverted
    intensities) and than no registration, scored on the un-remapped moving
    volume warped by each recovered field (the JAX package's
    ``test_multimodal_nmi_beats_ssd``)."""
    tile, shape = (6, 6, 6), (28, 24, 20)
    fixed, moving, _ = make_pair(shape, tile=tile, magnitude=1.5, seed=2, device="cpu")
    remapped = (1.0 - moving) ** 1.5
    maes = {}
    for sim in ("ssd", "nmi"):
        opts = RegistrationOptions(tile=tile, levels=2, iters=25, similarity=sim)
        res = ffd_register(fixed, remapped, options=opts, device="cpu")
        disp = ffd.dense_field(res.params, tile, shape, mode="ttli")
        maes[sim] = metrics.mae(ffd.warp_volume(moving, disp), fixed).item()
    assert maes["nmi"] < maes["ssd"], maes
    assert maes["nmi"] < metrics.mae(moving, fixed).item(), maes
