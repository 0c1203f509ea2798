"""Multi-GPU: the mesh of ranks over ``torch.distributed``, the row-sharded
news table and token store, the data-parallel train steps (the tower's, the
joint, the content scorer's and the end-to-end ones), the sharded flat
eval, the sequence-sharded tower, the sharded and tensor-parallel encoder,
and the sharded scoring that mesh serving (``serve.Ranker(mesh=)``) runs."""

from .mesh import Mesh, build_mesh, launch, multihost_init
from .sharding import (
    ShardedStore,
    ShardedTable,
    batch_sharding,
    make_sequence_sharded_tower_fn,
    make_sharded_classification_step,
    make_sharded_e2e_train_step,
    make_sharded_e2e_train_step_gathered,
    make_sharded_encode_fn,
    make_sharded_flat_tower_train_step,
    make_sharded_joint_train_step,
    make_sharded_scoring_fn,
    make_sharded_tower_train_step,
    replicated,
    shard_encoder_params_tp,
    shard_news_table,
    shard_token_store_states,
    store_sharding,
    table_sharding,
)

__all__ = [
    "Mesh",
    "ShardedStore",
    "ShardedTable",
    "batch_sharding",
    "build_mesh",
    "launch",
    "make_sequence_sharded_tower_fn",
    "make_sharded_classification_step",
    "make_sharded_e2e_train_step",
    "make_sharded_e2e_train_step_gathered",
    "make_sharded_encode_fn",
    "make_sharded_flat_tower_train_step",
    "make_sharded_joint_train_step",
    "make_sharded_scoring_fn",
    "make_sharded_tower_train_step",
    "multihost_init",
    "replicated",
    "shard_encoder_params_tp",
    "shard_news_table",
    "shard_token_store_states",
    "store_sharding",
    "table_sharding",
]
