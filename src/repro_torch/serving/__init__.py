"""Quasi-synchronous serving subsystem, slab and paged slices, speculative
decoding and chunked prefill, the telemetry sinks and the hardware-cost
probe (port of ``repro/serving``): slots ~ synchronization groups, the
admission queue ~ operand queues, and the scheduler's lead window ~ the
inter-group elasticity parameter E."""

from repro_torch.serving.block_pool import (TRASH_BLOCK, BlockPool,
                                           NoFreeBlocks, PagedCacheManager)
from repro_torch.serving.cache_manager import (BaseCacheManager, CacheManager,
                                               make_cache_manager)
from repro_torch.serving.engine import (GenerationResult, RequestResult,
                                        ServeConfig, ServeLoop, ServeReport,
                                        ServingEngine)
from repro_torch.serving.executor import SingleDeviceExecutor, make_executor
from repro_torch.serving.probe import (NULL_PROBE, PROBE_METHODS,
                                       SparsityProbe, probe_supported)
from repro_torch.serving.queue import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import (QuasiSyncScheduler,
                                           SchedulerConfig, SLOClass)
from repro_torch.serving.speculative import (Drafter, ModelDrafter,
                                             PromptLookupDrafter,
                                             make_drafter)
from repro_torch.serving.telemetry import (SCHEMA_VERSION, MetricsLogger,
                                           StreamSummary, Telemetry, Tracer,
                                           percentiles, read_jsonl,
                                           reduce_stream)

__all__ = [
    "BaseCacheManager", "BlockPool", "CacheManager", "Drafter",
    "GenerationResult", "MetricsLogger", "ModelDrafter", "NULL_PROBE",
    "NoFreeBlocks", "PROBE_METHODS", "PagedCacheManager",
    "PromptLookupDrafter", "QuasiSyncScheduler", "Request", "RequestQueue",
    "RequestResult", "RequestState", "SCHEMA_VERSION", "SLOClass",
    "SchedulerConfig", "ServeConfig", "ServeLoop", "ServeReport",
    "ServingEngine", "SingleDeviceExecutor", "SparsityProbe",
    "StreamSummary", "TRASH_BLOCK", "Telemetry", "Tracer",
    "make_cache_manager", "make_drafter", "make_executor", "percentiles",
    "probe_supported", "read_jsonl", "reduce_stream",
]
