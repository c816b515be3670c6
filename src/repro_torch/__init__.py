"""PyTorch and CUDA port of the B-spline registration engine.

A second package beside the JAX one (``repro``), mirroring its module names.
It imports ``torch`` and numpy only.  Its entry points run on the card unless
the caller passes ``device="cpu"``; every hand-written CUDA kernel has a plain
PyTorch version in the same module, which runs for CPU tensors.
"""

from repro_torch.core.options import RegistrationOptions
from repro_torch.core.registration import RegistrationResult, ffd_register
from repro_torch.data.volumes import PAPER_VOLUMES, make_pair, make_phantom

__all__ = [
    "PAPER_VOLUMES",
    "RegistrationOptions",
    "RegistrationResult",
    "ffd_register",
    "make_pair",
    "make_phantom",
]
