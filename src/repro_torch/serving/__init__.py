"""Tiered paged-KV serving: the cache controller and the engine."""

from repro_torch.serving.engine import PreemptedRequest, Request, TieredEngine
from repro_torch.serving.kv_cache import ParkedSlot, TieredKVCache

__all__ = [
    "TieredEngine",
    "TieredKVCache",
    "Request",
    "PreemptedRequest",
    "ParkedSlot",
]
