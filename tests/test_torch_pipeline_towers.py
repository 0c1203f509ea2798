"""The port's ``AttentionComponent`` and ``FinalAttentionComponent`` over
the latent tower (the flat step under the margin loss, the padded step
under InfoNCE, the fused flat eval) against the JAX package's, from the
same starting weights, on ``tests/test_torch_pipeline_world.py``'s data:
scores and metrics within 1e-5."""

import pytest

from test_torch_pipeline_world import classified, check_attention_components, world  # noqa: F401  (fixtures)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)


@pytest.mark.parametrize("loss", ["margin", "infonce"])
def test_latent_attention_components_match_jax(classified, loss):
    """``AttentionComponent`` trained on the train split with the dev split
    for its epoch eval (the query tables read by both), then its scores
    over the classification baseline, and ``FinalAttentionComponent`` from
    the trained tower."""
    check_attention_components(classified, "latent", loss)
