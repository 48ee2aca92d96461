from .ops import bwd_head_splits, flash_attention, flash_attention_bwd, flash_attention_fwd
from .ref import attention_lse_ref, attention_ref, flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "attention_ref",
           "flash_attention_ref", "attention_lse_ref", "flash_attention_bwd_ref",
           "bwd_head_splits"]
