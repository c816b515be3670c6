"""PyTorch and CUDA port of the B-spline registration engine.

A second package beside the JAX one (``repro``), mirroring its module names.
It imports ``torch`` and numpy only.  Its entry points run on the card unless
the caller passes ``device="cpu"``; every hand-written CUDA kernel has a plain
PyTorch version in the same module, which runs for CPU tensors.
"""

from repro_torch.core.options import RegistrationOptions
from repro_torch.core.registration import (RegistrationResult, affine_register,
                                           ffd_register)
from repro_torch.core.regularizer import bending
from repro_torch.core.transform import displacement, jacobian_determinant, velocity
from repro_torch.data.volumes import PAPER_VOLUMES, make_pair, make_phantom
from repro_torch.engine.batch import BatchRegistrationResult, register_batch
from repro_torch.engine.convergence import ConvergenceConfig
from repro_torch.engine.optimizer import adam, gauss_newton, lbfgs
from repro_torch.engine.serve import (AsyncRegistrationService, QueueFull,
                                      RegistrationScheduler, RegistrationTimeout)

__all__ = [
    "AsyncRegistrationService",
    "BatchRegistrationResult",
    "ConvergenceConfig",
    "PAPER_VOLUMES",
    "QueueFull",
    "RegistrationOptions",
    "RegistrationResult",
    "RegistrationScheduler",
    "RegistrationTimeout",
    "adam",
    "affine_register",
    "bending",
    "displacement",
    "ffd_register",
    "gauss_newton",
    "jacobian_determinant",
    "lbfgs",
    "make_pair",
    "make_phantom",
    "register_batch",
    "velocity",
]
