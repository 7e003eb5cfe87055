from .engine import Request, ServingEngine
from .kv_cache import KVCache
from .metrics import Metrics
from .paged_cache import PagedKVCache
from .sampler import ArgMaxSampler, Sampler

__all__ = ["ArgMaxSampler", "KVCache", "Metrics", "PagedKVCache", "Request",
           "Sampler", "ServingEngine"]
