"""The port's B-spline basis and LUTs equal the JAX package's bitwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bspline as ref  # noqa: E402
from repro_torch.core import bspline as port  # noqa: E402


@pytest.mark.parametrize("delta", [1, 2, 3, 4, 5, 6, 7, 8])
def test_weight_and_lerp_luts_bitwise(delta):
    assert np.array_equal(np.asarray(ref.weight_lut(delta)),
                          port.weight_lut(delta).numpy())
    for a, b in zip(ref.lerp_luts(delta), port.lerp_luts(delta)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert port.weight_lut(delta).dtype == torch.float32


@pytest.mark.parametrize("tile", [(5, 5, 5), (5, 4, 3), (3, 3, 3), (7, 6, 5)])
def test_basis_matrix_bitwise(tile):
    assert np.array_equal(np.asarray(ref.basis_matrix(tile)),
                          port.basis_matrix(tile).numpy())


def test_basis_and_grid_points_bitwise():
    u = np.random.default_rng(0).uniform(0.0, 1.0, 4096).astype(np.float32)
    a = np.asarray(ref.bspline_basis(jnp.asarray(u)))
    b = port.bspline_basis(torch.from_numpy(u)).numpy()
    assert np.array_equal(a, b)
    np.testing.assert_allclose(b.sum(-1), 1.0, atol=1e-6)  # partition of unity
    assert ref.grid_points_for_tiles((4, 7, 1)) == port.grid_points_for_tiles((4, 7, 1))
