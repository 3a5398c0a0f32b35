from repro_torch.serving.engine import Engine, EngineKnobs, EngineStats
from repro_torch.serving.kvcache import CachePool, PagedCachePool
from repro_torch.serving.request import Request

__all__ = ["CachePool", "Engine", "EngineKnobs", "EngineStats",
           "PagedCachePool", "Request"]
