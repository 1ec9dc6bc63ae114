"""The model zoo. The reference also exports ``ActivationSharding`` here;
the port's models take no sharding argument, and the record lives in
``repro_torch.runtime.sharding``."""

from repro_torch.models.transformer import DecodeState, Model, init_decode_state

__all__ = ["Model", "DecodeState", "init_decode_state"]
