from .kernel import launches, reset_launches
from .ops import swa_attention, swa_attention_gqa
from .ref import swa_attention_ref

__all__ = ["launches", "reset_launches", "swa_attention",
           "swa_attention_gqa", "swa_attention_ref"]
