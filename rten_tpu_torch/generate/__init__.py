from .engine import Request, ServingEngine
from .kv_cache import KVCache
from .metrics import Metrics
from .sampler import ArgMaxSampler, Sampler

__all__ = ["ArgMaxSampler", "KVCache", "Metrics", "Request", "Sampler",
           "ServingEngine"]
