"""The whole slice: the port's ``ffd_register`` against the JAX package's.

The reference is pinned to ``mode="ttli", impl="jnp", grad_impl="jnp",
fused="off"``; the port runs its defaults (fused level step, the TTLI and
adjoint kernels) on the CPU, where the kernels' plain versions run.
Registration outputs are held at 1e-4, as the reference holds its own paths.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.core.registration import ffd_register as ref_register  # noqa: E402
from repro.data.volumes import make_pair as ref_make_pair  # noqa: E402
from repro.engine.batch import ffd_level_loss as ref_level_loss  # noqa: E402
from repro_torch import (RegistrationOptions, ffd_register,  # noqa: E402
                         make_pair)
from repro_torch.convert import grid_from_numpy, options_from_reference  # noqa: E402
from repro_torch.engine.batch import ffd_level_objective  # noqa: E402

SHAPE = (28, 24, 20)
REF_FIELDS = dict(mode="ttli", impl="jnp", grad_impl="jnp", fused="off", levels=2,
                  iters=5)


@pytest.fixture(scope="module")
def pair():
    return tuple(np.array(a) for a in ref_make_pair(SHAPE, seed=0))  # writable


@pytest.fixture(scope="module")
def ref_result(pair):
    fixed, moving, _ = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ref_register(fixed, moving, options=RefOptions(**REF_FIELDS))


def test_make_pair_matches_reference(pair):
    fixed, moving, phi_true = make_pair(SHAPE, seed=0, device="cpu")
    assert np.array_equal(fixed.numpy(), pair[0])
    assert np.array_equal(phi_true.numpy(), pair[2])
    np.testing.assert_allclose(moving.numpy(), pair[1], atol=1e-5)


def test_ffd_register_matches_reference(pair, ref_result):
    fixed, moving, _ = pair
    out = ffd_register(fixed, moving, options=RegistrationOptions(levels=2, iters=5),
                       device="cpu")
    assert out.params.dtype == torch.float32
    np.testing.assert_allclose(out.losses, ref_result.losses, rtol=1e-4)
    np.testing.assert_allclose(out.params.numpy(), np.asarray(ref_result.params),
                               atol=1e-4)
    np.testing.assert_allclose(out.warped.numpy(), np.asarray(ref_result.warped),
                               atol=1e-4)


def test_level_loss_and_gradient_from_a_reference_grid(pair, ref_result):
    fixed, moving, _ = pair
    phi_np = np.asarray(ref_result.params)
    kw = dict(tile=(5, 5, 5), bending_weight=5e-3, mode="ttli")
    ref_loss, ref_grad = jax.value_and_grad(ref_level_loss(
        jnp.asarray(fixed), jnp.asarray(moving), impl="jnp", grad_impl="jnp", **kw))(
            jnp.asarray(phi_np))
    opts = options_from_reference(REF_FIELDS)
    phi = grid_from_numpy(phi_np, "cpu")
    loss, grad = ffd_level_objective(
        torch.from_numpy(fixed), torch.from_numpy(moving), impl="cuda",
        grad_impl="cuda", fused="on", **kw).vg(phi)
    assert opts.impl == "torch" and opts.grad_impl == "torch"
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref_grad = np.asarray(ref_grad)
    assert np.abs(grad.numpy() - ref_grad).max() <= 1e-5 * np.abs(ref_grad).max()


def test_measure_bsi_time_reports_seconds(pair):
    fixed, moving, _ = pair
    opts = RegistrationOptions(levels=1, iters=1)
    out = ffd_register(fixed, moving, options=opts, device="cpu",
                       measure_bsi_time=True)
    assert out.bsi_seconds > 0 and len(out.losses) == 1


@pytest.mark.parametrize("fields,error,match", [
    (dict(impl="auto"), NotImplementedError, "queue 1 item 13"),
    (dict(fused="auto"), NotImplementedError, "queue 1 item 13"),
    (dict(similarity="nmi"), NotImplementedError, "queue 1 item 8"),
    (dict(transform="velocity"), NotImplementedError, "queue 1 item 11"),
    (dict(regularizer="bending"), NotImplementedError, "queue 1 item 11"),
    (dict(optimizer="lbfgs"), NotImplementedError, "queue 1 item 12"),
    (dict(compute_dtype="bfloat16"), NotImplementedError, "queue 1 item 18"),
    (dict(mode="separable"), NotImplementedError, "queue 2 item 6"),
    (dict(grad_impl="matmul"), NotImplementedError, "queue 2 item 5"),
    (dict(impl="torch", mode="tt"), NotImplementedError, "queue 1 item 2"),
    (dict(mode="gather"), ValueError, "no kernel"),
    (dict(grad_impl="autograd"), ValueError, "autograd"),
    (dict(impl="pallas"), ValueError, "impl must be one of"),
    (dict(iters=0), ValueError, "iters"),
])
def test_options_name_what_is_not_ported(fields, error, match):
    with pytest.raises(error, match=match):
        RegistrationOptions(**fields)


def test_options_from_reference_maps_the_renamed_values():
    ref = RefOptions(**REF_FIELDS)
    fields = {k: getattr(ref, k) for k in ref.__dataclass_fields__}
    opts = options_from_reference(fields)
    assert (opts.mode, opts.impl, opts.grad_impl, opts.fused) == (
        "ttli", "torch", "torch", "off")
    assert (opts.levels, opts.iters, opts.tile) == (2, 5, (5, 5, 5))
    pallas = options_from_reference(dict(impl="pallas", grad_impl="pallas",
                                         fused=True))
    assert (pallas.impl, pallas.grad_impl, pallas.fused) == ("cuda", "cuda", "on")
    with pytest.raises(NotImplementedError):
        options_from_reference(dict(mode="auto"))
