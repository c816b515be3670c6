"""The legacy-kwarg shim (``core.options.merge_legacy_options``): the JAX
package's ``tests/test_options.py`` deprecation and bit-equivalence cases,
ported.

Every entry point takes ``options=``; the legacy keyword spelling still
works, warns once per call site, and builds the same options object, so it
returns bit-identical results.  ``ffd_register``'s legacy spelling is also
held against the JAX package's at 1e-4.  The port runs on the CPU here.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.registration import ffd_register as ref_ffd_register  # noqa: E402
from repro_torch import (ConvergenceConfig, RegistrationOptions,  # noqa: E402
                         affine_register, ffd_register, register_batch)
from repro_torch.core.options import (UNSET, _reset_deprecation_registry,  # noqa: E402
                                      merge_legacy_options)
from repro_torch.engine.loop import make_adam_runner  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
SHAPE = (18, 16, 14)
SMALL = dict(tile=(6, 6, 6), levels=2, iters=4, lr=0.1, mode="separable",
             impl="cuda", grad_impl="cuda")  # the kernels' plain versions on the CPU


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=SHAPE).astype(np.float32)
    return f, np.roll(f, 1, axis=0)


def _deprecations(w):
    return [x for x in w if issubclass(x.category, DeprecationWarning)]


class TestDeprecationShim:
    def test_unset_is_a_falsy_singleton(self):
        assert type(UNSET)() is UNSET and not UNSET and repr(UNSET) == "UNSET"

    def test_mixing_options_and_kwargs_raises(self):
        with pytest.raises(TypeError, match="not both"):
            merge_legacy_options("fn", RegistrationOptions(), dict(iters=3, lr=UNSET))

    def test_non_options_object_raises(self):
        with pytest.raises(TypeError, match="RegistrationOptions"):
            merge_legacy_options("fn", {"iters": 3}, dict(iters=UNSET))

    def test_options_pass_through_unwarned(self):
        o = RegistrationOptions(iters=3)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert merge_legacy_options("fn", o, dict(iters=UNSET, lr=UNSET)) is o

    def test_warns_once_per_call_site(self):
        _reset_deprecation_registry()

        def call_site():
            return merge_legacy_options("fn", None, dict(iters=3, lr=UNSET), stacklevel=2)

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(3):
                call_site()  # one site, three calls
            merge_legacy_options("fn", None, dict(iters=3, lr=UNSET),
                                 stacklevel=2)  # a second site
        deps = _deprecations(w)
        assert len(deps) == 2
        assert "iters" in str(deps[0].message)

    def test_warning_names_the_passed_fields(self):
        _reset_deprecation_registry()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            merge_legacy_options("fn", None, dict(iters=3, transform="velocity", lr=UNSET),
                                 stacklevel=2)
        deps = _deprecations(w)
        assert len(deps) == 1
        assert "RegistrationOptions(iters=..., transform=...)" in str(deps[0].message)

    def test_make_adam_runner_requires_a_config(self):
        with pytest.raises(TypeError, match="options=RegistrationOptions"):
            make_adam_runner(lambda: None)
        # either spelling satisfies it (the legacy one warns as usual)
        make_adam_runner(lambda: None, options=RegistrationOptions(iters=2, lr=0.1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            make_adam_runner(lambda: None, iters=2, lr=0.1)

    def test_legacy_kwargs_overlay_defaults(self):
        _reset_deprecation_registry()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            o = merge_legacy_options("fn", None, dict(iters=9, lr=UNSET),
                                     defaults=RegistrationOptions(iters=60, lr=0.02))
        assert (o.iters, o.lr) == (9, 0.02)

    def test_no_kwargs_give_the_defaults_unwarned(self):
        base = RegistrationOptions(iters=60, lr=0.02)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert merge_legacy_options("fn", None, dict(iters=UNSET)) == \
                RegistrationOptions()
            assert merge_legacy_options("fn", None, dict(iters=UNSET),
                                        defaults=base) is base


def _same(a, b):
    return torch.equal(a.warped, b.warped) and torch.equal(a.params, b.params)


class TestBitwiseEquivalence:
    """The kwarg path equals the options path bit for bit."""

    def test_ffd_register(self):
        f, m = _pair()
        _reset_deprecation_registry()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            legacy = ffd_register(f, m, device="cpu", **SMALL)
        assert _deprecations(w)
        viaopts = ffd_register(f, m, options=RegistrationOptions(**SMALL), device="cpu")
        assert _same(legacy, viaopts) and legacy.losses == viaopts.losses

    def test_ffd_register_matches_reference(self):
        f, m = _pair()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            legacy = ffd_register(f, m, device="cpu", **SMALL)
            ref = ref_ffd_register(f, m, **dict(SMALL, impl="jnp", grad_impl="jnp"))
        assert np.abs(legacy.warped.numpy() - np.asarray(ref.warped)).max() <= 1e-4
        assert np.abs(legacy.params.numpy() - np.asarray(ref.params)).max() <= 1e-4
        np.testing.assert_allclose(legacy.losses, ref.losses, rtol=1e-4)

    def test_ffd_register_with_stop(self):
        f, m = _pair(1)
        stop = ConvergenceConfig(tol=3e-4, patience=3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            legacy = ffd_register(f, m, stop=stop, device="cpu", **SMALL)
        viaopts = ffd_register(f, m, options=RegistrationOptions(stop=stop, **SMALL),
                               device="cpu")
        assert legacy.steps == viaopts.steps and _same(legacy, viaopts)

    def test_ffd_register_transform_regularizer_kwargs(self):
        f, m = _pair(5)
        _reset_deprecation_registry()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            legacy = ffd_register(f, m, transform="velocity", regularizer="bending",
                                  device="cpu", **SMALL)
        deps = _deprecations(w)
        assert deps and "transform" in str(deps[0].message)
        viaopts = ffd_register(f, m, options=RegistrationOptions(
            transform="velocity", regularizer="bending", **SMALL), device="cpu")
        assert _same(legacy, viaopts) and legacy.losses == viaopts.losses

    def test_affine_register(self):
        f, m = _pair(2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            legacy = affine_register(f, m, iters=4, lr=0.01, device="cpu")
        viaopts = affine_register(f, m, options=RegistrationOptions(iters=4, lr=0.01),
                                  device="cpu")
        assert _same(legacy, viaopts) and legacy.losses == viaopts.losses

    def test_affine_register_legacy_overlays_its_defaults(self):
        f, m = _pair(2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            legacy = affine_register(f, m, iters=4, device="cpu")  # lr stays 0.02
        viaopts = affine_register(f, m, options=RegistrationOptions(iters=4, lr=0.02),
                                  device="cpu")
        assert _same(legacy, viaopts)

    def test_register_batch(self):
        f0, m0 = _pair(3)
        f1, m1 = _pair(4)
        F, M = np.stack([f0, f1]), np.stack([m0, m1])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            legacy = register_batch(F, M, device="cpu", **SMALL)
        viaopts = register_batch(F, M, options=RegistrationOptions(**SMALL), device="cpu")
        assert _same(legacy, viaopts) and torch.equal(legacy.losses, viaopts.losses)

    def test_make_adam_runner(self):
        target = torch.linspace(-1.0, 1.0, 12)

        def build(t):
            return lambda p: ((p - t) ** 2).sum()

        p0 = torch.zeros(12)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            legacy = make_adam_runner(build, iters=5, lr=0.1)(p0, target)
        viaopts = make_adam_runner(build, options=RegistrationOptions(iters=5, lr=0.1))(
            p0, target)
        assert all(torch.equal(a, b) for a, b in zip(legacy, viaopts))
        # Adam's b1/b2/eps fold into the default spec, as in the JAX package
        other = make_adam_runner(build, options=RegistrationOptions(iters=5, lr=0.1),
                                 b2=0.9)(p0, target)
        assert not torch.equal(other[1], viaopts[1])

    @pytest.mark.parametrize("entry", ["ffd_register", "affine_register",
                                       "register_batch", "make_adam_runner"])
    def test_mixing_raises_at_entry_points(self, entry):
        f, m = _pair()
        with pytest.raises(TypeError, match="not both"):
            if entry == "ffd_register":
                ffd_register(f, m, options=RegistrationOptions(), iters=3, device="cpu")
            elif entry == "affine_register":
                affine_register(f, m, options=RegistrationOptions(), lr=0.1, device="cpu")
            elif entry == "register_batch":
                register_batch(f[None], m[None], options=RegistrationOptions(), tile=(6, 6, 6),
                               device="cpu")
            else:
                make_adam_runner(lambda: None, options=RegistrationOptions(), iters=3, lr=0.1)

    def test_one_warning_per_entry_point_call_site(self):
        f, m = _pair()
        _reset_deprecation_registry()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(2):
                affine_register(f, m, iters=2, device="cpu")
        deps = _deprecations(w)
        assert len(deps) == 1 and "affine_register" in str(deps[0].message)
        assert deps[0].filename == __file__
