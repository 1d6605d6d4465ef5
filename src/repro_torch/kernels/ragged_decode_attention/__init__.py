from repro_torch.kernels.ragged_decode_attention.ops import (
    ragged_decode_attention, split_count)
from repro_torch.kernels.ragged_decode_attention.ref import (
    decode_attention_reference, split_decode_attention_reference)

__all__ = ["ragged_decode_attention", "split_count",
           "decode_attention_reference", "split_decode_attention_reference"]
