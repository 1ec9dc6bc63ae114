"""Optimizers of the port, after ``repro.optim``: AdamW, tiered (compressed)
Adam moments, and int8 error-feedback gradient compression."""
from repro_torch.optim import adamw, grad_compress, tiered_adam
from repro_torch.optim.adamw import AdamWConfig, cosine_schedule

__all__ = ["adamw", "tiered_adam", "grad_compress", "AdamWConfig", "cosine_schedule"]
