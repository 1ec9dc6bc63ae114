"""Step builders of the port: sharding specs, train, serve and the elastic
runner."""

from repro_torch.runtime import elastic, serve, sharding, train

__all__ = ["sharding", "train", "serve", "elastic"]
