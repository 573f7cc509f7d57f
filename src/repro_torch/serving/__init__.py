"""Quasi-synchronous serving subsystem, slab slice (port of
``repro/serving``): slots ~ synchronization groups, the admission queue ~
operand queues, and the scheduler's lead window ~ the inter-group
elasticity parameter E."""

from repro_torch.serving.cache_manager import (BaseCacheManager, CacheManager,
                                               make_cache_manager)
from repro_torch.serving.engine import (GenerationResult, RequestResult,
                                        ServeConfig, ServeLoop, ServeReport,
                                        ServingEngine)
from repro_torch.serving.executor import SingleDeviceExecutor, make_executor
from repro_torch.serving.queue import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import (QuasiSyncScheduler,
                                           SchedulerConfig, SLOClass)
from repro_torch.serving.telemetry import (StreamSummary, Telemetry,
                                           percentiles, reduce_stream)

__all__ = [
    "BaseCacheManager", "CacheManager", "GenerationResult",
    "QuasiSyncScheduler", "Request", "RequestQueue", "RequestResult",
    "RequestState", "SLOClass", "SchedulerConfig", "ServeConfig",
    "ServeLoop", "ServeReport", "ServingEngine", "SingleDeviceExecutor",
    "StreamSummary", "Telemetry", "make_cache_manager", "make_executor",
    "percentiles", "reduce_stream",
]
