from repro_torch.kernels.ragged_decode_attention.ops import ragged_decode_attention
from repro_torch.kernels.ragged_decode_attention.ref import decode_attention_reference

__all__ = ["ragged_decode_attention", "decode_attention_reference"]
