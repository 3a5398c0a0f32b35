from repro_torch.serving.engine import Engine, EngineKnobs, EngineStats
from repro_torch.serving.kvcache import PagedCachePool
from repro_torch.serving.request import Request

__all__ = ["Engine", "EngineKnobs", "EngineStats", "PagedCachePool",
           "Request"]
