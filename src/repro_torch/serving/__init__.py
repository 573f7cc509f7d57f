"""Quasi-synchronous serving subsystem, slab and paged slices, speculative
decoding and chunked prefill, the telemetry sinks, the hardware-cost
probe, fault injection with its recovery ladder, and the HTTP/SSE front
door with its multi-replica router (port of ``repro/serving``): slots ~
synchronization groups, the admission queue ~ operand queues, and the
scheduler's lead window ~ the inter-group elasticity parameter E."""

from repro_torch.serving.block_pool import (TRASH_BLOCK, BlockPool,
                                           NoFreeBlocks, PagedCacheManager)
from repro_torch.serving.cache_manager import (BaseCacheManager, CacheManager,
                                               make_cache_manager)
from repro_torch.serving.engine import (GenerationResult, RequestResult,
                                        ServeConfig, ServeLoop, ServeReport,
                                        ServingEngine)
from repro_torch.serving.executor import SingleDeviceExecutor, make_executor
from repro_torch.serving.faults import (NULL_INJECTOR, DeviceOOM,
                                        DrafterFault, FaultInjector,
                                        InjectedFault, StepFault,
                                        StepTimeout, TransientStepFault)
from repro_torch.serving.frontdoor import (FrontDoor, FrontDoorClient,
                                           FrontDoorServer, Replica, Router)
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
    "BaseCacheManager", "BlockPool", "CacheManager", "DeviceOOM", "Drafter",
    "DrafterFault", "FaultInjector", "FrontDoor", "FrontDoorClient",
    "FrontDoorServer", "GenerationResult", "InjectedFault", "MetricsLogger",
    "ModelDrafter", "NULL_INJECTOR", "NULL_PROBE", "NoFreeBlocks",
    "PROBE_METHODS", "PagedCacheManager", "PromptLookupDrafter",
    "QuasiSyncScheduler", "Replica", "Request", "RequestQueue",
    "RequestResult", "RequestState", "Router", "SCHEMA_VERSION", "SLOClass",
    "SchedulerConfig", "ServeConfig", "ServeLoop", "ServeReport",
    "ServingEngine", "SingleDeviceExecutor", "SparsityProbe", "StepFault",
    "StepTimeout", "StreamSummary", "TRASH_BLOCK", "Telemetry", "Tracer",
    "TransientStepFault", "make_cache_manager", "make_drafter",
    "make_executor", "percentiles", "probe_supported", "read_jsonl",
    "reduce_stream",
]
