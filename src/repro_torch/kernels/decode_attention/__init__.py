from .ops import decode_attention, merge_lse
from .paged import paged_decode_attention
from .paged_prefill import paged_prefill_attention
from .ref import (
    decode_attention_ref,
    decode_attention_ref_model,
    gather_pages,
    paged_decode_attention_ref,
    paged_prefill_attention_ref,
    quantize_kv,
)

__all__ = [
    "decode_attention",
    "decode_attention_ref",
    "decode_attention_ref_model",
    "gather_pages",
    "merge_lse",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "paged_prefill_attention",
    "paged_prefill_attention_ref",
    "quantize_kv",
]
