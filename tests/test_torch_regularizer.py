"""The analytic bending energy against the JAX package's ``repro.core.regularizer``.

The Gram matrices are the same numpy arithmetic and equal bit for bit; the
energy and its closed-form gradient ``2 Q phi`` are held at 1e-5 relative
against the JAX package's ``custom_vjp`` energy and against autograd of the
port's own plain ``energy.reference``.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import regularizer as rreg  # noqa: E402
from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.core.registration import ffd_register as ref_register  # noqa: E402
from repro.data.volumes import make_pair as ref_make_pair  # noqa: E402
from repro_torch import ffd_register  # noqa: E402
from repro_torch.convert import options_from_reference  # noqa: E402
from repro_torch.core import ffd  # noqa: E402
from repro_torch.core import regularizer as treg  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
GRIDS = [((9, 8, 7), (5, 5, 5)), ((12, 10, 9), (4, 3, 5))]


def _phi(gshape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(gshape + (3,)) * 0.7).astype(np.float32)


@pytest.mark.parametrize("n", [4, 7, 13, 50])
def test_gram_matrices_equal_reference(n):
    for ref, out in zip(rreg.bending_gram_matrices(n), treg.bending_gram_matrices(n)):
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("gshape,tile", GRIDS)
def test_energy_and_gradient_match_reference(gshape, tile):
    phi = _phi(gshape)
    ref_e, ref_g = jax.value_and_grad(rreg.bending_energy_fn(gshape, tile))(
        jnp.asarray(phi))
    energy = treg.bending_energy_fn(gshape, tile)
    p = torch.from_numpy(phi).requires_grad_(True)
    e = energy(p)
    (g,) = torch.autograd.grad(e, p)
    assert abs(e.item() - float(ref_e)) <= 1e-5 * abs(float(ref_e))
    ref_g = np.asarray(ref_g)
    assert np.abs(g.numpy() - ref_g).max() <= 1e-5 * np.abs(ref_g).max()
    # the closed form against autograd through the plain products
    p2 = torch.from_numpy(phi).requires_grad_(True)
    e2 = energy.reference(p2)
    (g2,) = torch.autograd.grad(e2, p2)
    assert abs(e.item() - e2.item()) <= 1e-5 * abs(e2.item())
    assert (g - g2).abs().max() <= 1e-5 * g2.abs().max()


def test_energy_vanishes_on_affine_fields():
    """A constant or linear field bends nowhere: zero energy (the JAX
    package's own check)."""
    gshape, tile = (9, 8, 7), (5, 5, 5)
    energy = treg.bending_energy_fn(gshape, tile)
    ii = torch.arange(gshape[0], dtype=torch.float32)[:, None, None, None]
    for phi in (torch.ones(gshape + (3,)) * 1.7, ii * torch.tensor([0.3, -0.2, 0.1])
                + torch.zeros(gshape + (3,))):
        assert abs(energy(phi).item()) <= 1e-6 * (phi ** 2).sum().item()


def test_bending_term_replaces_the_proxy():
    gshape, tile = (9, 8, 7), (5, 5, 5)
    phi = torch.from_numpy(_phi(gshape, 1))
    legacy = treg.regularizer_term("none", grid_shape=gshape, tile=tile,
                                   bending_weight=5e-3)
    assert legacy(phi).item() == (5e-3 * ffd.bending_energy(phi)).item()
    term = treg.regularizer_term(treg.bending(weight=2e-3), grid_shape=gshape,
                                 tile=tile, bending_weight=5e-3)
    energy = treg.bending_energy_fn(gshape, tile)
    assert term(phi).item() == (2e-3 * energy(phi)).item()
    ref = rreg.regularizer_term(rreg.bending(weight=2e-3), grid_shape=gshape, tile=tile,
                                bending_weight=5e-3)(jnp.asarray(phi.numpy()))
    assert abs(term(phi).item() - float(ref)) <= 1e-5 * abs(float(ref))


def test_registry_tokens_and_validation():
    assert treg.resolve_regularizer("bending") == treg.bending() == treg.BendingRegularizer()
    assert treg.regularizer_token(treg.bending(weight=5e-3)) == rreg.regularizer_token(
        rreg.bending(weight=5e-3))
    assert treg.regularizer_token("none") == "none"
    assert treg.available_regularizers() == ["bending", "none"]
    with pytest.raises(ValueError, match="weight"):
        treg.bending(weight=-1.0)


def test_ffd_register_bending_matches_reference():
    """The whole registration with the analytic bending energy (Adam, the
    displacement transform) against the reference pinned to ``mode="ttli",
    impl="jnp", grad_impl="jnp", fused="off"``: losses, grid and warp at
    1e-4 (measured 1.4e-6 relative, 9.2e-6 and 7.3e-7)."""
    fields = dict(mode="ttli", impl="jnp", grad_impl="jnp", fused="off", levels=2,
                  iters=5, regularizer="bending")
    fixed, moving, _ = (np.array(a) for a in ref_make_pair((28, 24, 20), seed=0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_register(fixed, moving, options=RefOptions(**fields))
    out = ffd_register(fixed, moving, options=options_from_reference(fields),
                       device="cpu")
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(out.params.numpy(), np.asarray(ref.params), atol=1e-4)
    np.testing.assert_allclose(out.warped.numpy(), np.asarray(ref.warped), atol=1e-4)
