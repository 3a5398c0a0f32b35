from repro_torch.serving.backend import (EngineBackend, EngineFleet,
                                         FleetBackend)
from repro_torch.serving.engine import (Engine, EngineKnobs, EngineStats,
                                        shard_compat)
from repro_torch.serving.kvcache import CachePool, PagedCachePool
from repro_torch.serving.request import Request
from repro_torch.serving.spec import EngineSpec, serving_plan

__all__ = ["CachePool", "Engine", "EngineBackend", "EngineFleet",
           "EngineKnobs", "EngineSpec", "EngineStats", "FleetBackend",
           "PagedCachePool", "Request", "serving_plan", "shard_compat"]
