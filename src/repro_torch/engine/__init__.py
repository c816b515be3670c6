"""The optimisation loop, the level objective, batched registration, its
sharding over a mesh and the continuous-batching scheduler."""

from repro_torch.engine.batch import BatchRegistrationResult, register_batch
from repro_torch.engine.serve import (AsyncRegistrationService, QueueFull,
                                      RegistrationScheduler, RegistrationTimeout)
from repro_torch.engine.shard import make_registration_mesh, sharded_pipeline

__all__ = ["AsyncRegistrationService", "BatchRegistrationResult", "QueueFull",
           "RegistrationScheduler", "RegistrationTimeout", "make_registration_mesh",
           "register_batch", "sharded_pipeline"]
