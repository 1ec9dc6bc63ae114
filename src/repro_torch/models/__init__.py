from repro_torch.models.transformer import DecodeState, Model, init_decode_state
