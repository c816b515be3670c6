"""The optimisation loop, the level objective, batched registration and the
continuous-batching scheduler."""

from repro_torch.engine.batch import BatchRegistrationResult, register_batch
from repro_torch.engine.serve import (AsyncRegistrationService, QueueFull,
                                      RegistrationScheduler, RegistrationTimeout)

__all__ = ["AsyncRegistrationService", "BatchRegistrationResult", "QueueFull",
           "RegistrationScheduler", "RegistrationTimeout", "register_batch"]
