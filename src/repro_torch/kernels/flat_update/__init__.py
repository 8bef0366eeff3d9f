from ._build import launches, reset_launches
from .ops import (FamilySpec, FlatAlgorithm, SendSpec, family_spec_for,
                  flat_master_update_batch, pack_state, send_spec_for,
                  unpack_state)
from .send import flat_send_view, flat_send_view_ref

__all__ = ["FamilySpec", "FlatAlgorithm", "SendSpec", "family_spec_for",
           "flat_master_update_batch", "flat_send_view",
           "flat_send_view_ref", "launches", "pack_state",
           "reset_launches", "send_spec_for", "unpack_state"]
