"""The port's autotuner against the JAX package's tests of its own.

Ports of ``tests/test_autotune_cache.py`` (the versioned disk cache),
``tests/test_engine.py`` and ``tests/test_adjoint.py`` (candidates, the
adjoint axis, ``resolve_bsi``), ``tests/test_fused_level.py`` (``fused="auto"``
on the CPU) and ``tests/test_convergence.py`` (``stop`` is refused), on the
CPU, where the candidate pool is the plain forms.  The parity test runs
``ffd_register`` with every axis ``"auto"`` and holds it against the JAX
package pinned to the triple the port resolved: per-level losses and MAE at
1e-4, as the other slice tests.
"""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as rmetrics  # noqa: E402
from repro.core.options import RegistrationOptions as RefOptions  # noqa: E402
from repro.core.registration import ffd_register as ref_register  # noqa: E402
from repro.data.volumes import make_pair as ref_make_pair  # noqa: E402
from repro.engine import autotune as rautotune  # noqa: E402
from repro_torch import RegistrationOptions, ffd_register  # noqa: E402
from repro_torch.convert import options_from_reference, reference_fields  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core.interpolate import GRAD_IMPLS, KERNEL_MODES  # noqa: E402
from repro_torch.engine import autotune  # noqa: E402
from repro_torch.engine.autotune import autotune_bsi, resolve_bsi  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
GRID, TILE = (7, 7, 7), (2, 2, 2)
CPU = torch.device("cpu")
PAIR = (("ttli", "torch", "torch"), ("separable", "torch", "torch"))


@pytest.fixture(autouse=True)
def fresh_tuner(tmp_path, monkeypatch):
    """No cache of another test, and none in the home directory."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "default.json"))
    autotune._MEM_CACHE.clear()
    autotune.resolve_options.cache_clear()
    autotune.RACES.clear()


def _tune(cache):
    # the in-process cache would otherwise answer before the disk is read
    autotune._MEM_CACHE.clear()
    return autotune_bsi(GRID, TILE, device=CPU, reps=1, cache_path=str(cache),
                        candidates=PAIR)


# --- the disk cache (tests/test_autotune_cache.py)


@pytest.mark.parametrize("payload", [
    b"{ this is not json",          # garbage
    b'{"cpu|g7x7x7|t2x2x2|c3',      # truncated mid-write
    b"[1, 2, 3]",                   # valid JSON, not a dict
    b"",                            # empty file
])
def test_corrupt_cache_triggers_clean_rebenchmark(tmp_path, payload):
    cache = tmp_path / "bsi_autotune.json"
    cache.write_bytes(payload)
    choice = _tune(cache)
    assert choice.mode in {"ttli", "separable"} and choice.us_per_call > 0
    data = json.loads(cache.read_text())
    assert data["__schema__"] == autotune.SCHEMA_VERSION
    assert isinstance(data["entries"], dict) and len(data["entries"]) == 1


def test_stale_schema_cache_is_a_miss_not_an_error(tmp_path):
    cache = tmp_path / "bsi_autotune.json"
    key = "cpu|g7x7x7|t2x2x2|c3|grad|sim=ssd|ttli/torch/torch,separable/torch/torch"
    # a flat {key: choice} dict, no schema wrapper
    cache.write_text(json.dumps({key: {"mode": "ttli", "impl": "torch",
                                       "us_per_call": 1.0}}))
    assert autotune._load_disk(str(cache)) == {}
    choice = _tune(cache)
    assert choice.mode in {"ttli", "separable"} and choice.us_per_call > 0
    assert json.loads(cache.read_text())["__schema__"] == autotune.SCHEMA_VERSION
    # a future schema is a miss as well
    cache.write_text(json.dumps(
        {"__schema__": autotune.SCHEMA_VERSION + 1, "entries": {"k": {}}}))
    assert autotune._load_disk(str(cache)) == {}


def test_reference_package_cache_is_a_miss(tmp_path):
    """A file the JAX package wrote (its schema, its key and value names) is
    a miss here: the port's schema is its own, and the rewrite upgrades it."""
    cache = tmp_path / "bsi_autotune.json"
    key = "cpu|g7x7x7|t2x2x2|c3|grad|sim=ssd|ttli/torch/torch,separable/torch/torch"
    cache.write_text(json.dumps({
        "__schema__": rautotune.SCHEMA_VERSION,
        "entries": {key: {"mode": "ttli", "impl": "jnp", "us_per_call": 1.0,
                          "grad_impl": "xla", "fused": "off"}}}))
    assert rautotune.SCHEMA_VERSION != autotune.SCHEMA_VERSION
    assert autotune._load_disk(str(cache)) == {}
    _tune(cache)
    data = json.loads(cache.read_text())
    assert data["__schema__"] == autotune.SCHEMA_VERSION
    assert all(v["us_per_call"] != 1.0 for v in data["entries"].values())


@pytest.mark.parametrize("bad", [
    {}, {"mode": "ttli"},
    {"mode": "ttli", "impl": "torch", "us_per_call": "fast", "grad_impl": "torch",
     "fused": "off"},
    {"mode": "ttli", "impl": "torch", "us_per_call": 1.0, "grad_impl": "torch",
     "fused": "sideways"},
    {"mode": "ttli", "impl": "jnp", "us_per_call": 1.0, "grad_impl": "torch",
     "fused": "off"},
    {"mode": "gather", "impl": "cuda", "us_per_call": 1.0, "grad_impl": "cuda",
     "fused": "off"},
    {"mode": "ttli", "impl": "cuda", "us_per_call": 1.0, "grad_impl": "autograd",
     "fused": "off"},
    "zap",
], ids=range(8))
def test_malformed_entry_is_a_miss_not_an_error(tmp_path, bad):
    cache = tmp_path / "bsi_autotune.json"
    first = _tune(cache)
    (key,) = json.loads(cache.read_text())["entries"]
    cache.write_text(json.dumps({"__schema__": autotune.SCHEMA_VERSION,
                                 "entries": {key: bad}}))
    autotune.RACES.clear()
    again = _tune(cache)  # re-measures; the winner may differ (timing noise)
    assert again.mode in {"ttli", "separable"} and again.us_per_call > 0
    assert len(autotune.RACES) == 1 and first.us_per_call > 0


def test_valid_cache_entry_still_round_trips(tmp_path):
    cache = tmp_path / "bsi_autotune.json"
    first = _tune(cache)
    cache.write_text(json.dumps(json.loads(cache.read_text())))
    autotune.RACES.clear()
    assert _tune(cache) == first
    assert autotune.RACES == []  # served from the file: no race


def test_per_similarity_cache_keys_are_distinct(tmp_path):
    cache = tmp_path / "bsi_autotune.json"
    for sim in ("ssd", "nmi"):
        choice = autotune_bsi(GRID, TILE, device=CPU, reps=1, cache_path=str(cache),
                              candidates=PAIR, similarity=sim)
        assert choice.us_per_call > 0
    entries = json.loads(cache.read_text())["entries"]
    assert len(entries) == 2
    assert any("|sim=ssd|" in k for k in entries)
    assert any("|sim=nmi|" in k for k in entries)
    assert all(k.startswith("cpu|g7x7x7|t2x2x2|c3|grad|") for k in entries)


def test_fused_race_entry_round_trips(tmp_path):
    """autotune_fused races on the device it is given, caches its decision
    and serves it back without a race."""
    cache = tmp_path / "bsi_autotune.json"
    base = autotune.BsiChoice("separable", "torch", 0.0, "torch")
    first = autotune.autotune_fused(GRID, TILE, (8, 8, 8), base=base, similarity="ssd",
                                    device=CPU, reps=1, cache_path=str(cache))
    assert first.fused in ("on", "off") and first.us_per_call > 0
    (race,) = autotune.RACES
    assert [name for name, _ in race.timings] == ["fused=off", "fused=on"]
    autotune._MEM_CACHE.clear()
    again = autotune.autotune_fused(GRID, TILE, (8, 8, 8), base=base, similarity="ssd",
                                    device=CPU, reps=1, cache_path=str(cache))
    assert again == first and len(autotune.RACES) == 1
    entries = json.loads(cache.read_text())["entries"]
    assert any("|fused|" in k for k in entries)


def test_fused_race_of_a_similarity_without_a_kernel_is_off():
    base = autotune.BsiChoice("ttli", "torch", 0.0, "torch")
    choice = autotune.autotune_fused(GRID, TILE, (8, 8, 8), base=base,
                                     similarity=lambda w, f: ((w - f) ** 2).mean(),
                                     device=CPU)
    assert choice.fused == "off" and autotune.RACES == []


# --- candidates and resolve_bsi (tests/test_engine.py, tests/test_adjoint.py)


def test_autotune_returns_valid_choice_and_caches(tmp_path):
    cache = tmp_path / "bsi_autotune.json"
    choice = autotune_bsi((8, 8, 8), (3, 3, 3), device=CPU, reps=1,
                          cache_path=str(cache))
    assert choice.mode in {"gather", "tt", "ttli", "separable", "matmul"}
    assert choice.impl == "torch"  # the CPU pool: the plain forms
    assert choice.grad_impl in ("autograd", "torch")
    assert choice.us_per_call > 0
    assert len(autotune.RACES[0].timings) == 10  # the whole CPU pool
    assert cache.exists()
    again = autotune_bsi((8, 8, 8), (3, 3, 3), device=CPU, reps=1,
                         cache_path=str(cache))
    assert again == choice
    other = tmp_path / "other.json"
    autotune_bsi((8, 8, 8), (3, 3, 3), device=CPU, reps=1, cache_path=str(other))
    assert other.exists()


def test_autotune_measure_grad_excludes_nondifferentiable(tmp_path):
    """A kernel forward has no autograd graph: crossed with the CPU's
    ("autograd", "torch") adjoints it keeps only "torch", so a kernel mode
    resolves with no race, and the refused pair is never timed."""
    assert resolve_bsi("ttli", "cuda", GRID, TILE, grad_impl="auto", device=CPU,
                       cache_path=str(tmp_path / "c.json")) == ("ttli", "cuda", "torch")
    assert autotune.RACES == []
    assert autotune._cross((("ttli", "cuda"), ("ttli", "torch")),
                           ("autograd", "torch")) == (
        ("ttli", "cuda", "torch"), ("ttli", "torch", "autograd"),
        ("ttli", "torch", "torch"))


def test_autotune_kernel_forward_survives_with_analytic_adjoint(tmp_path):
    choice = autotune_bsi(GRID, TILE, device=CPU, reps=1,
                          candidates=(("ttli", "cuda", "torch"),
                                      ("separable", "cuda", "torch")),
                          cache_path=str(tmp_path / "c.json"))
    assert (choice.impl, choice.grad_impl) == ("cuda", "torch")
    (race,) = autotune.RACES
    assert [name for name, _ in race.timings] == ["ttli/cuda/torch",
                                                  "separable/cuda/torch"]
    assert all(us > 0 for _, us in race.timings)


def test_resolve_bsi_passthrough_and_partial_auto(tmp_path):
    assert resolve_bsi("tt", "torch", (8, 8, 8), (3, 3, 3), grad_impl="torch",
                       device=CPU) == ("tt", "torch", "torch")
    assert autotune.RACES == []  # nothing to resolve, nothing timed
    mode, impl, gi = resolve_bsi("separable", "auto", (8, 8, 8), (3, 3, 3),
                                 grad_impl="torch", device=CPU, reps=1,
                                 cache_path=str(tmp_path / "c.json"))
    assert (mode, impl, gi) == ("separable", "torch", "torch")  # one CPU candidate
    # an explicit impl takes its forms on any device: on the CPU the kernels'
    # plain versions run
    mode, impl, gi = resolve_bsi("auto", "cuda", GRID, TILE, grad_impl="torch",
                                 device=CPU, reps=1,
                                 cache_path=str(tmp_path / "p.json"))
    assert impl == "cuda" and mode in KERNEL_MODES and gi == "torch"
    assert len(autotune.RACES[-1].timings) == len(KERNEL_MODES)
    with pytest.raises(ValueError):
        resolve_bsi("nosuch", "auto", (8, 8, 8), (3, 3, 3), grad_impl="torch",
                    device=CPU)


def test_autotune_enumerates_adjoint_axis(tmp_path):
    mode, impl, gi = resolve_bsi("separable", "torch", (8, 8, 8), (3, 3, 3),
                                 device=CPU, grad_impl="auto", reps=1,
                                 cache_path=str(tmp_path / "c.json"))
    assert (mode, impl) == ("separable", "torch")
    assert gi in ("autograd", "torch")  # the CPU's adjoints
    assert [n for n, _ in autotune.RACES[0].timings] == [
        "separable/torch/autograd", "separable/torch/torch"]
    assert resolve_bsi("tt", "torch", (8, 8, 8), (3, 3, 3), device=CPU,
                       grad_impl="torch") == ("tt", "torch", "torch")
    with pytest.raises(ValueError, match="grad_impl"):
        resolve_bsi("tt", "torch", (8, 8, 8), (3, 3, 3), device=CPU, grad_impl="xla")


@pytest.mark.parametrize("device,n", [("cpu", 10), ("cuda", 12)])
def test_candidate_pools(device, n):
    """The CUDA pool of ``impl="auto"``: every kernel form with the three
    analytic adjoints (the options refuse a kernel forward under autograd),
    and no plain form; the CPU pool: the plain forms with the plain
    adjoints.  Building a pool reads only the device's type: no card is
    needed."""
    pool = autotune._cross(autotune._candidate_pool("auto", "auto", device),
                           autotune.default_grad_impls(device))
    assert len(pool) == len(set(pool)) == n
    assert all(g in GRAD_IMPLS for _, _, g in pool)
    assert not any(i == "cuda" and g == "autograd" for _, i, g in pool)
    for mode, impl, grad_impl in pool:  # every candidate is valid options
        RegistrationOptions(mode=mode, impl=impl, grad_impl=grad_impl)
    impls = {i for _, i, _ in pool}
    assert impls == ({"cuda"} if device == "cuda" else {"torch"})
    # a mode with no kernel takes its plain form; an explicit impl its forms
    assert autotune._candidate_pool("gather", "auto", device) == (("gather", "torch"),)
    assert autotune._candidate_pool("auto", "torch", device) == (
        autotune.PLAIN_CANDIDATES)


def test_out_of_memory_is_recorded_and_other_errors_propagate(tmp_path, monkeypatch):
    """A plain candidate that runs out of device memory is recorded as "did
    not fit" (None) and stepped past; a kernel candidate's out-of-memory
    error, and any other error of a candidate, raises."""
    real = autotune.interpolate

    def interpolate(phi, tile, *, mode, impl, **kw):
        if mode == "gather" or impl == "cuda":
            raise torch.cuda.OutOfMemoryError(f"{mode}/{impl} does not fit")
        if mode == "tt":
            raise RuntimeError("kernel launch failed")
        return real(phi, tile, mode=mode, impl=impl, **kw)

    monkeypatch.setattr(autotune, "interpolate", interpolate)
    choice = autotune_bsi(GRID, TILE, device=CPU, reps=1,
                          candidates=(("gather", "torch", "autograd"),
                                      ("ttli", "torch", "autograd")),
                          cache_path=str(tmp_path / "c.json"))
    assert choice.mode == "ttli"
    assert autotune.RACES[0].timings[0] == ("gather/torch/autograd", None)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        autotune_bsi(GRID, TILE, device=CPU, reps=1,
                     candidates=(("tt", "torch", "torch"), ("ttli", "torch", "torch")),
                     cache_path=str(tmp_path / "d.json"))
    with pytest.raises(torch.cuda.OutOfMemoryError, match="ttli/cuda"):
        autotune_bsi(GRID, TILE, device=CPU, reps=1,
                     candidates=(("ttli", "cuda", "torch"), ("ttli", "torch", "torch")),
                     cache_path=str(tmp_path / "k.json"))
    with pytest.raises(RuntimeError, match="no BSI candidate fit"):
        autotune_bsi(GRID, TILE, device=CPU, reps=1,
                     candidates=(("gather", "torch", "torch"),),
                     cache_path=str(tmp_path / "e.json"))


def test_unwritable_cache_warns_and_keeps_the_choice(tmp_path):
    """A cache file that cannot be written is said, not swallowed; the
    choice is still returned and kept in this process."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    cache = str(blocker / "bsi_autotune.json")
    with pytest.warns(RuntimeWarning, match="not written"):
        first = autotune_bsi(GRID, TILE, device=CPU, reps=1, cache_path=cache,
                             candidates=PAIR)
    assert autotune_bsi(GRID, TILE, device=CPU, reps=1, cache_path=cache,
                        candidates=PAIR) == first
    assert len(autotune.RACES) == 1


# --- resolve_options (tests/test_fused_level.py, tests/test_convergence.py)


def test_fused_auto_resolves_off_on_cpu():
    opts = RegistrationOptions(tile=(4, 4, 4), levels=1, iters=2, mode="separable",
                               impl="torch", grad_impl="autograd", fused="auto")
    resolved = autotune.resolve_options(opts, (20, 20, 20), CPU)
    assert resolved.fused == "off" and "cpu device" in resolved.fused_reason
    assert autotune.RACES == []  # nothing was measured


def test_resolve_options_passes_concrete_options_through():
    opts = RegistrationOptions(fused="on")
    resolved = autotune.resolve_options(opts, (20, 20, 20), CPU)
    assert resolved == opts and resolved.fused_reason == "forced on"
    assert autotune.resolve_options(opts, (20, 20, 20), CPU) is resolved  # cached
    off = autotune.resolve_options(RegistrationOptions(fused="off"), (20, 20, 20), CPU)
    assert off.fused_reason == "forced off"
    custom = RegistrationOptions(similarity=lambda w, f: ((w - f) ** 2).mean(),
                                 fused="auto", impl="torch", grad_impl="torch")
    resolved = autotune.resolve_options(custom, (20, 20, 20), CPU)
    assert resolved.fused == "off" and resolved.fused_reason.startswith("unsupported")
    assert autotune.RACES == []
    with pytest.raises(TypeError):
        autotune.resolve_options("ttli", (20, 20, 20), CPU)


@pytest.mark.parametrize("fields", [dict(transform="velocity"),
                                    dict(optimizer="gauss_newton")],
                         ids=["velocity", "gauss_newton"])
def test_fused_auto_resolves_off_without_a_race_for_velocity_and_gauss_newton(fields):
    """Neither has a fused level step: ``"auto"`` resolves ``"off"`` with the
    reference's reason, on any device, and nothing is raced."""
    opts = RegistrationOptions(mode="ttli", impl="torch", grad_impl="torch", **fields)
    resolved = autotune.resolve_options(opts, (20, 20, 20), CPU)
    ref = rautotune.resolve_options(RefOptions(
        mode="ttli", impl="jnp", grad_impl="jnp", **fields), (20, 20, 20))
    assert resolved.fused == ref.fused == "off"
    assert resolved.fused_reason == ref.fused_reason
    assert autotune.RACES == []
    with pytest.raises(ValueError, match="fused='on'"):
        RegistrationOptions(fused="on", **fields)


def test_velocity_and_optimizer_key_their_races_apart(tmp_path):
    """Velocity times scaling and squaring before the warp and keys
    ``|tf=``; a non-default optimiser keys ``|opt=``; the defaults add
    neither, so their entries stay valid."""
    cache = tmp_path / "bsi_autotune.json"
    for kw in (dict(), dict(transform="velocity"), dict(optimizer="lbfgs"),
               dict(transform="displacement", optimizer="adam")):
        autotune_bsi(GRID, TILE, device=CPU, reps=1, cache_path=str(cache),
                     candidates=PAIR, **kw)
    keys = sorted(json.loads(cache.read_text())["entries"])
    assert len(keys) == 3 and len(autotune.RACES) == 3  # the defaults hit
    assert sum("|tf=velocity(squarings=6)|" in k for k in keys) == 1
    assert sum("|opt=lbfgs(history=10,max_ls=10)|" in k for k in keys) == 1
    plain = [k for k in keys if "|tf=" not in k and "|opt=" not in k]
    assert plain == ["cpu|g7x7x7|t2x2x2|c3|grad|sim=ssd|"
                     "ttli/torch/torch,separable/torch/torch"]
    ref_key_parts = ("|tf=velocity(squarings=6)", "|opt=lbfgs(history=10,max_ls=10)")
    from repro.core.transform import transform_token as rtoken
    from repro.engine.optimizer import optimizer_token as rotoken
    assert ref_key_parts == (f"|tf={rtoken('velocity')}", f"|opt={rotoken('lbfgs')}")


def test_autotune_rejects_stop():
    with pytest.raises(ValueError, match="stop"):
        autotune_bsi((8, 8, 8), (3, 3, 3), device=CPU, stop=object())
    assert autotune.RACES == []


# --- the slice on the CPU against the JAX package


def test_auto_ffd_register_matches_the_reference_pinned_to_its_choice(monkeypatch):
    """All-"auto" options on the CPU: the resolved triple, mapped back, lies
    in the JAX package's CPU pool; the run equals the JAX package's with its
    options pinned to that triple (per-level losses and MAE at 1e-4)."""
    monkeypatch.delenv("REPRO_AUTOTUNE_PALLAS", raising=False)
    fixed, moving, _ = (np.array(a) for a in ref_make_pair((28, 24, 20), seed=0))
    opts = options_from_reference(dict(mode="auto", impl="auto", grad_impl="auto",
                                       fused="auto", levels=2, iters=5))
    ops.reset_launch_counts()
    out = ffd_register(fixed, moving, options=opts, device="cpu")
    assert not any(ops.launch_counts().values())  # the plain versions ran
    (race,) = autotune.RACES  # one race, before the pyramid; no fused race
    assert len(race.timings) == 10
    resolved = autotune.resolve_options(opts, (28, 24, 20), CPU)  # the call's
    fields = reference_fields(resolved)
    ref_pool = {c + (g,) for c in rautotune.default_candidates()
                for g in rautotune.default_grad_impls()}
    assert (fields["mode"], fields["impl"], fields["grad_impl"]) in ref_pool
    assert fields["fused"] == "off"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_register(fixed, moving, options=RefOptions(levels=2, iters=5,
                                                             **fields))
    np.testing.assert_allclose(out.losses, ref.losses, rtol=1e-4)
    ref_mae = float(rmetrics.mae(ref.warped, fixed))
    mae = metrics.mae(out.warped, torch.from_numpy(fixed)).item()
    assert abs(mae - ref_mae) <= 1e-4 * ref_mae
