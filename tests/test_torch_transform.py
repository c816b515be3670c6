"""The velocity transform against the JAX package's ``repro.core.transform``.

The same seeded numpy fields go through both packages: the composition,
scaling and squaring (K = 1 and 6) and the inverse flow at 1e-5 of the
largest displacement, the Jacobian determinant at 1e-5.  The port samples the
three channels of a field with one index computation and recomputes each
composition in the backward; its gradient is held against plain autograd of
the same compositions and against the JAX package's.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import transform as rtf  # noqa: E402
from repro.core.ffd import grid_shape_for_volume as rgrid_shape  # noqa: E402
from repro.core.ffd import trilinear_sample as rtrilinear  # noqa: E402
from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.core.registration import ffd_register as ref_register  # noqa: E402
from repro.data.volumes import make_pair as ref_make_pair  # noqa: E402
from repro_torch import ffd_register, jacobian_determinant  # noqa: E402
from repro_torch.convert import options_from_reference  # noqa: E402
from repro_torch.core import ffd  # noqa: E402
from repro_torch.core import transform as tf  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
VOL, TILE = (20, 18, 16), (5, 5, 5)


def _field(seed, scale):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(VOL + (3,)) * scale).astype(np.float32)


def _grid(seed, scale=1.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(rgrid_shape(VOL, TILE) + (3,)) * scale).astype(np.float32)


def _close(out, ref, rel=1e-5):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(out) - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_compose_displacement_matches_reference():
    u, v = _field(0, 2.0), _field(1, 3.0)  # v reaches past the borders: clamps
    ref = rtf.compose_displacement(jnp.asarray(u), jnp.asarray(v))
    out = tf.compose_displacement(torch.from_numpy(u), torch.from_numpy(v))
    _close(out.numpy(), ref)


def test_channels_share_one_index_computation_bit_for_bit():
    """``ffd.trilinear_sample`` of a field, its channels gathered by one set
    of corner indices, equals the sampling of each channel alone bit for
    bit, clamped corners included."""
    u = torch.from_numpy(_field(2, 1.0))
    coords = torch.from_numpy(_field(3, 6.0)) + ffd.identity_grid(VOL)
    out = ffd.trilinear_sample(u, coords)
    for c in range(3):
        assert torch.equal(out[..., c], ffd.trilinear_sample(u[..., c].contiguous(),
                                                             coords))


@pytest.mark.parametrize("squarings", [1, 6])
def test_scaling_and_squaring_matches_reference(squarings):
    vel = _field(4, 2.5)
    ref = rtf.scaling_and_squaring(jnp.asarray(vel), squarings)
    out = tf.scaling_and_squaring(torch.from_numpy(vel), squarings)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_dense_displacement_velocity_matches_reference(inverse):
    phi = _grid(5)
    ref = rtf.dense_displacement("velocity", jnp.asarray(phi), TILE, VOL, mode="ttli",
                                 impl="jnp", grad_impl="jnp", inverse=inverse)
    out = tf.dense_displacement("velocity", torch.from_numpy(phi), TILE, VOL,
                                mode="ttli", impl="cuda", grad_impl="cuda",
                                inverse=inverse)
    _close(out.numpy(), ref)


def test_inverse_flow_inverts_forward():
    """``(id + inverse) o (id + forward) - id`` stays under 1e-3 voxels
    inside the volume on the JAX package's own smooth field
    (``tests/test_transform.py``: tile 8, a (40, 40, 40) volume)."""
    tile, vol = (8, 8, 8), (40, 40, 40)
    ii, jj, kk = np.meshgrid(*(np.arange(n) for n in rgrid_shape(vol, tile)),
                             indexing="ij")
    phi = 0.5 * np.stack([np.sin(0.6 * ii + 0.3 * jj), np.cos(0.5 * jj + 0.2 * kk),
                          np.sin(0.4 * kk + 0.25 * ii)], axis=-1).astype(np.float32)
    kw = dict(mode="ttli", impl="torch", grad_impl="torch")
    fwd = tf.dense_displacement(tf.velocity(), torch.from_numpy(phi), tile, vol, **kw)
    inv = tf.dense_displacement("velocity", torch.from_numpy(phi), tile, vol,
                                inverse=True, **kw)
    assert fwd.abs().max() > 0.2
    assert tf.compose_displacement(inv, fwd)[2:-2, 2:-2, 2:-2].abs().max() <= 1e-3


def test_displacement_has_no_inverse():
    with pytest.raises(ValueError, match="no analytic inverse"):
        tf.dense_displacement("displacement", torch.zeros(7, 7, 7, 3), TILE, (10,) * 3,
                              inverse=True)


def test_velocity_gradient_matches_reference_and_plain_autograd():
    """The gradient of ``sum(w * flow(phi))``: recomputed compositions
    against the same compositions saved (plain autograd) and against
    ``jax.grad`` of the JAX package's flow, at 1e-5 of the largest entry."""
    phi, w = _grid(7), _field(8, 1.0)
    kw = dict(mode="ttli", impl="cuda", grad_impl="cuda")

    def loss(p, recompute):
        vel = ffd.dense_field(p, TILE, VOL, **kw) / 2.0 ** 6
        u = vel
        for _ in range(6):
            u = (tf.scaling_and_squaring(u * 2.0, 1) if recompute
                 else tf.compose_displacement(u, u))
        return (u * torch.from_numpy(w)).sum()

    grads = []
    for recompute in (True, False):
        p = torch.from_numpy(phi).requires_grad_(True)
        (g,) = torch.autograd.grad(loss(p, recompute), p)
        grads.append(g.numpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    ref = jax.grad(lambda p: jnp.sum(jnp.asarray(w) * rtf.dense_displacement(
        "velocity", p, TILE, VOL, mode="ttli", impl="jnp", grad_impl="jnp")))(
            jnp.asarray(phi))
    _close(grads[0], ref)


def test_jacobian_determinant_matches_reference():
    disp = _field(9, 0.8)
    ref = rtf.jacobian_determinant(jnp.asarray(disp))
    out = jacobian_determinant(torch.from_numpy(disp))
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5
    assert (np.asarray(ref) < 0).any()  # the field folds somewhere: both signs held
    fold = torch.zeros(8, 8, 8, 3)
    fold[..., 0] = -2.0 * torch.arange(8.0)[:, None, None]  # x reflected: det = -1
    assert torch.allclose(jacobian_determinant(fold), torch.tensor(-1.0))


def test_clamped_gather_forward_mode_splits_ties_like_jnp_clip():
    """At ``u = 0`` every border voxel sits on a clamp bound; the tangent of
    the warp there must be ``jnp.clip``'s (0.5 at a tie), as Gauss-Newton's
    first step starts there."""
    rng = np.random.default_rng(10)
    vol = rng.random(VOL).astype(np.float32)
    tangent = rng.standard_normal(VOL + (3,)).astype(np.float32)
    ident = ffd.identity_grid(VOL)
    zero = torch.zeros(VOL + (3,))
    _, jv = torch.func.jvp(lambda d: ffd.trilinear_sample(torch.from_numpy(vol), ident + d),
                           (zero,), (torch.from_numpy(tangent),))
    rident = jnp.asarray(ident.numpy())
    _, rjv = jax.jvp(lambda d: rtrilinear(jnp.asarray(vol), rident + d),
                     (jnp.zeros(VOL + (3,)),), (jnp.asarray(tangent),))
    _close(jv.numpy(), rjv)


def test_registry_tokens_and_validation():
    assert tf.resolve_transform("velocity") == tf.velocity() == tf.VelocityTransform(6)
    assert tf.transform_token(tf.velocity(squarings=4)) == "velocity(squarings=4)"
    assert tf.transform_token("displacement") == "displacement"
    assert tf.available_transforms() == ["displacement", "velocity"]
    with pytest.raises(ValueError, match="squarings"):
        tf.velocity(squarings=0)


def test_ffd_register_velocity_matches_reference():
    """The whole registration with the velocity transform (Adam, the
    ``bending_weight`` proxy) against the reference pinned to ``mode="ttli",
    impl="jnp", grad_impl="jnp", fused="off"``: losses, grid and warp at
    1e-4 (measured 4.4e-7 relative, 6.5e-5 and 8.0e-7)."""
    fields = dict(mode="ttli", impl="jnp", grad_impl="jnp", fused="off", levels=2,
                  iters=5, transform="velocity")
    fixed, moving, _ = (np.array(a) for a in ref_make_pair((28, 24, 20), seed=0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_register(fixed, moving, options=RefOptions(**fields))
    out = ffd_register(fixed, moving, options=options_from_reference(fields),
                       device="cpu")
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(out.params.numpy(), np.asarray(ref.params), atol=1e-4)
    np.testing.assert_allclose(out.warped.numpy(), np.asarray(ref.warped), atol=1e-4)
