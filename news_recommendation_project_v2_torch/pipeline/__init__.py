"""The step pipeline and its components."""

from .components import (
    AttentionAttentionComponent,
    AttentionComponent,
    AttentionReduceComponent,
    AttentionWeightComponent,
    ClassificationComponent,
    EmbeddingsComponent,
    FinalAttentionComponent,
    LoadEmbeddingComponent,
    SaveEmbeddingComponent,
    StoreTokenStatesComponent,
    TokenEmbeddingsComponent,
    TransformDataComponent,
)
from .pipeline import Pipeline, PipelineComponent, check_req_keys

__all__ = [
    "AttentionAttentionComponent",
    "AttentionComponent",
    "StoreTokenStatesComponent",
    "AttentionReduceComponent",
    "AttentionWeightComponent",
    "ClassificationComponent",
    "EmbeddingsComponent",
    "FinalAttentionComponent",
    "LoadEmbeddingComponent",
    "Pipeline",
    "PipelineComponent",
    "SaveEmbeddingComponent",
    "TokenEmbeddingsComponent",
    "TransformDataComponent",
    "check_req_keys",
]
