from .kernel import launches, reset_launches
from .ops import dana_master_update, dana_master_update_leaf
from .ref import dana_master_update_ref

__all__ = ["dana_master_update", "dana_master_update_leaf",
           "dana_master_update_ref", "launches", "reset_launches"]
