"""Serving tier of the port: the generation lane and what it stands on
(registry, admission, tenancy)."""

from . import admission, generation, registry, tenancy
from .admission import (AdmissionController, CacheExhaustedError,
                        DeadlineExceededError, QuotaExceededError,
                        ReplicaDeadError, ServerDrainingError,
                        ServerOverloadedError, ServingError,
                        UnknownModelError)
from .generation import GenerationRequest, GenerationScheduler, LMBackend
from .registry import Backend, ModelRegistry
from .tenancy import FairQueue, TenantPolicy, TokenBucket

__all__ = ["AdmissionController", "Backend", "CacheExhaustedError",
           "DeadlineExceededError", "FairQueue", "GenerationRequest",
           "GenerationScheduler", "LMBackend", "ModelRegistry",
           "QuotaExceededError", "ReplicaDeadError", "ServerDrainingError",
           "ServerOverloadedError", "ServingError", "TenantPolicy",
           "TokenBucket", "UnknownModelError", "admission", "generation",
           "registry", "tenancy"]
