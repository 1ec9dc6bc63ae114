"""Host data pipeline of the port, after ``repro.data``."""
from repro_torch.data.pipeline import DataConfig, HostLoader, synthetic_corpus

__all__ = ["DataConfig", "HostLoader", "synthetic_corpus"]
