"""Host-side data helpers (numpy)."""

from .compiler import CompiledBehaviors, compile_behaviors
from .grouping import dense_rank_by_segment, expand_items, group_items, lengths_to_offsets, lengths_to_segment_ids
from .sampling import sample_pos_neg_infonce, sample_pos_neg_pairs

__all__ = [
    "CompiledBehaviors",
    "compile_behaviors",
    "dense_rank_by_segment",
    "expand_items",
    "group_items",
    "lengths_to_offsets",
    "lengths_to_segment_ids",
    "sample_pos_neg_infonce",
    "sample_pos_neg_pairs",
]
