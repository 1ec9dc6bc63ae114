"""Tiered paged-KV serving: the cache controller and the engine."""
