"""Multi-GPU: the mesh of ranks over ``torch.distributed``, the row-sharded
news table, the data-parallel train steps and the sharded flat eval. The
sharded token store, the sequence-sharded tower and the e2e step are not
ported yet (ROADMAP.md §1): their names raise ``NotImplementedError``."""

from .mesh import Mesh, build_mesh, launch, multihost_init
from .sharding import (
    ShardedTable,
    batch_sharding,
    make_sequence_sharded_tower_fn,
    make_sharded_classification_step,
    make_sharded_e2e_train_step,
    make_sharded_flat_tower_train_step,
    make_sharded_joint_train_step,
    make_sharded_tower_train_step,
    replicated,
    shard_news_table,
    shard_token_store_states,
    store_sharding,
    table_sharding,
)

__all__ = [
    "Mesh",
    "ShardedTable",
    "batch_sharding",
    "build_mesh",
    "launch",
    "make_sequence_sharded_tower_fn",
    "make_sharded_classification_step",
    "make_sharded_e2e_train_step",
    "make_sharded_flat_tower_train_step",
    "make_sharded_joint_train_step",
    "make_sharded_tower_train_step",
    "multihost_init",
    "replicated",
    "shard_news_table",
    "shard_token_store_states",
    "store_sharding",
    "table_sharding",
]
