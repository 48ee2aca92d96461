from .ops import decode_attention
from .ref import decode_attention_ref, decode_attention_ref_model

__all__ = ["decode_attention", "decode_attention_ref", "decode_attention_ref_model"]
