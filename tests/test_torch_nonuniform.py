"""Non-uniform BSI (``core.nonuniform``): the JAX package's three cases
(``tests/test_bspline_core.py``) ported, and the port against
``repro.core.nonuniform`` on the same numpy grids.

The forward is held at 1e-5 at fractional and integer spacing.  The
gradient (autograd through the 64 clamped gathers) at fractional spacing is
held against ``jax.vjp`` at 1e-5 of its largest entry: each control point sums a few
thousand voxel contributions, which the two frameworks add in different
orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nonuniform as ref  # noqa: E402
from repro_torch.core import interpolate  # noqa: E402
from repro_torch.core.nonuniform import (axis_weights, bsi_nonuniform,  # noqa: E402
                                         grid_points_for_spacing)

from test_torch_cpu_threads import one_torch_thread  # noqa: E402, F401
FRACTIONAL = ((4.7, 3.3, 5.9), (17, 13, 19))
INTEGER = ((5.0, 4.0, 3.0), (20, 16, 12))


def _points(phi, pts, spacing):
    """Eq. (1) at continuous points, a voxel at a time in float64."""
    phi = phi.astype(np.float64)
    out = np.zeros(pts.shape[:-1] + (phi.shape[-1],))
    for idx in np.ndindex(pts.shape[:-1]):
        x = pts[idx] / np.asarray(spacing)
        base = np.floor(x).astype(int)
        u = x - base
        w = [np.array([(1 - t) ** 3, 3 * t**3 - 6 * t**2 + 4,
                       -3 * t**3 + 3 * t**2 + 3 * t + 1, t**3]) / 6 for t in u]
        for l, m, n in np.ndindex(4, 4, 4):
            g = [min(max(base[a] + o, 0), phi.shape[a] - 1) for a, o in enumerate((l, m, n))]
            out[idx] += w[0][l] * w[1][m] * w[2][n] * phi[g[0], g[1], g[2]]
    return out


def test_matches_aligned_at_integer_spacing():
    """At integer spacing the non-uniform path is the aligned one."""
    rng = np.random.default_rng(13)
    phi = torch.from_numpy(rng.standard_normal((7, 6, 5, 2)).astype(np.float32))
    aligned = interpolate.bsi_gather(phi, (5, 4, 3))
    out = bsi_nonuniform(phi, (5.0, 4.0, 3.0), tuple(aligned.shape[:3]))
    np.testing.assert_allclose(out.numpy(), aligned.numpy(), atol=3e-6)


def test_matches_points_at_fractional_spacing():
    rng = np.random.default_rng(14)
    spacing, vol = FRACTIONAL
    gshape = grid_points_for_spacing(vol, spacing)
    phi = rng.standard_normal(gshape + (2,)).astype(np.float32)
    out = bsi_nonuniform(torch.from_numpy(phi), spacing, vol)
    pts = np.stack(np.meshgrid(*(np.arange(s, dtype=np.float64) for s in vol),
                               indexing="ij"), -1)
    np.testing.assert_allclose(out.numpy(), _points(phi, pts, spacing), atol=5e-6)


def test_constant_reproduction():
    phi = torch.full((8, 8, 8, 1), -1.75)
    out = bsi_nonuniform(phi, (2.6, 3.1, 4.9), (12, 12, 12))
    np.testing.assert_allclose(out.numpy(), -1.75, atol=1e-5)


@pytest.mark.parametrize("spacing, vol", [FRACTIONAL, INTEGER], ids=["fractional", "integer"])
def test_matches_reference(spacing, vol):
    gshape = grid_points_for_spacing(vol, spacing)
    assert gshape == ref.grid_points_for_spacing(vol, spacing)
    for axis in range(3):
        idx, w = axis_weights(vol[axis], spacing[axis])
        ridx, rw = ref.axis_weights(vol[axis], spacing[axis])
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-7)
    rng = np.random.default_rng(15)
    phi = rng.standard_normal(gshape + (3,)).astype(np.float32)
    want = np.asarray(ref.bsi_nonuniform(jnp.asarray(phi), spacing, vol))
    got = bsi_nonuniform(torch.from_numpy(phi), spacing, vol)
    assert got.shape == vol + (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_gradient_matches_reference_vjp():
    spacing, vol = FRACTIONAL
    rng = np.random.default_rng(16)
    phi = rng.standard_normal(grid_points_for_spacing(vol, spacing) + (3,)).astype(np.float32)
    cot = rng.standard_normal(vol + (3,)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: ref.bsi_nonuniform(p, spacing, vol), jnp.asarray(phi))
    want_g = np.asarray(vjp(jnp.asarray(cot))[0])
    p = torch.from_numpy(phi).requires_grad_(True)
    bsi_nonuniform(p, spacing, vol).backward(torch.from_numpy(cot))
    assert np.abs(p.grad.numpy() - want_g).max() <= 1e-5 * np.abs(want_g).max()
