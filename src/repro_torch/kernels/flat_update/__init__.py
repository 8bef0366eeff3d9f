from ._build import launches, reset_launches
from .ops import (FLAT_ELIGIBLE, SEND_KERNEL, FamilySpec, FlatAlgorithm,
                  SendSpec, eligibility_matrix, family_spec_for,
                  flat_master_update_batch, kernel_eligible, merge_flat,
                  pack_state, send_spec_for, shard_bitexact, slice_flat,
                  unpack_state)
from .send import flat_send_view, flat_send_view_ref

__all__ = ["FLAT_ELIGIBLE", "FamilySpec", "FlatAlgorithm", "SEND_KERNEL",
           "SendSpec", "eligibility_matrix", "family_spec_for",
           "flat_master_update_batch", "flat_send_view",
           "flat_send_view_ref", "kernel_eligible", "launches",
           "merge_flat", "pack_state", "reset_launches", "send_spec_for",
           "shard_bitexact", "slice_flat", "unpack_state"]
