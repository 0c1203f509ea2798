"""Small learned towers: the content-only MLP scorer (with or without a
category embedding), the additive-attention history pooler, the score
blender, the dimension reducer, and two wrappers (category embeddings in
front of a tower, a linear bottleneck around one).

The port of the JAX package's ``models/towers.py``; parameter names follow
the reference torch modules, so the JAX package's converters in
``models/convert_towers.py`` read these ``state_dict``s.
``FinalAttention`` keeps the reference's per-dimension exp weights over the
history axis (weights [B, L, D]) and its float32 readout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EMBEDDING_DIM, REDUCED_DIM
from .attention import exp_weight_readout
from .layers import dense, dropout


class ClassificationHead(nn.Module):
    """3-layer ReLU MLP ``in_dim -> hidden_dim -> hidden_dim -> out_dim``: the
    content-only (cold-start) scorer. [..., in_dim] -> [..., out_dim]."""

    def __init__(self, in_dim: int = EMBEDDING_DIM, hidden_dim: int = EMBEDDING_DIM, out_dim: int = 1):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, hidden_dim)
        self.linear_2 = nn.Linear(hidden_dim, hidden_dim)
        self.linear_3 = nn.Linear(hidden_dim, out_dim)

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.linear_1(embeddings))
        x = F.relu(self.linear_2(x))
        return self.linear_3(x)


class ClassificationHeadCatEmbed(nn.Module):
    """The content scorer whose input's last feature is a category id,
    replaced by a learned ``cat_dim`` embedding before the MLP; ``in_dim``
    is the MLP's input width (the other features plus ``cat_dim``)."""

    def __init__(
        self,
        in_dim: int = EMBEDDING_DIM,
        hidden_dim: int = EMBEDDING_DIM,
        out_dim: int = 1,
        num_categories: int = 15,
        cat_dim: int = 128,
    ):
        super().__init__()
        self.cat_embed = nn.Embedding(num_categories, cat_dim)
        self.linear_1 = nn.Linear(in_dim, hidden_dim)
        self.linear_2 = nn.Linear(hidden_dim, hidden_dim)
        self.linear_3 = nn.Linear(hidden_dim, out_dim)

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        cat = self.cat_embed(embeddings[..., -1].long())
        x = torch.cat([embeddings[..., :-1], cat], dim=-1)
        x = F.relu(self.linear_1(x))
        x = F.relu(self.linear_2(x))
        return self.linear_3(x)


class FinalAttention(nn.Module):
    """Additive-attention history pooler: a transform
    ``reduced_dim -> hidden -> hidden -> reduced_dim`` (ReLU, dropout), a
    weight head ``reduced_dim -> hidden -> reduced_dim`` (the last layer
    without bias), then the exp weights masked over the history, normalised
    per dimension, and the weighted sum: [B, L, D], [B, L] -> [B, D] in the
    compute type."""

    def __init__(
        self,
        reduced_dim: int = REDUCED_DIM,
        hidden_dim: int = 4096,
        dropout_rate: float = 0.1,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dropout_rate, self.compute_dtype = dropout_rate, compute_dtype
        self.linear1 = nn.Linear(reduced_dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, hidden_dim)
        self.linear3 = nn.Linear(hidden_dim, reduced_dim)
        self.linear4 = nn.Linear(reduced_dim, hidden_dim)
        self.linear5 = nn.Linear(hidden_dim, reduced_dim, bias=False)

    def forward(
        self,
        embeddings: torch.Tensor,
        attention_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cdt, rate = self.compute_dtype, self.dropout_rate
        x = dropout(F.relu(dense(self.linear1, embeddings, cdt)), rate, generator)
        x = dropout(F.relu(dense(self.linear2, x, cdt)), rate, generator)
        x = dense(self.linear3, x, cdt)
        w = dropout(F.relu(dense(self.linear4, x, cdt)), rate, generator)
        return exp_weight_readout(x, dense(self.linear5, w, cdt), attention_mask)


class WeightedSumModel(nn.Module):
    """``cos * sigmoid(alpha) + baseline * (1 - sigmoid(alpha))``, the
    learned blend of the tower's cosine score and the content baseline;
    ``alpha`` starts at 0."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(()))

    def forward(self, cos_sim: torch.Tensor, baseline: torch.Tensor) -> torch.Tensor:
        alpha = torch.sigmoid(self.alpha)
        return cos_sim * alpha + baseline * (1 - alpha)


class ReducingModel(nn.Module):
    """2-layer MLP projector ``input_dim -> output_dim -> output_dim``."""

    def __init__(self, input_dim: int = EMBEDDING_DIM, output_dim: int = REDUCED_DIM):
        super().__init__()
        self.linear = nn.Linear(input_dim, output_dim)
        self.linear2 = nn.Linear(output_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear(x)))


class EmbeddingWrapper(nn.Module):
    """Learned category and subcategory embeddings, read from the input's last
    two features (ids), replace them before the wrapped tower (which takes
    the other features plus ``2 * cat_dim``)."""

    def __init__(self, wrapped: nn.Module, num_categories: int = 15, num_subcategories: int = 134, cat_dim: int = 128):
        super().__init__()
        self.wrapped_model = wrapped
        self.cat_embed = nn.Embedding(num_categories, cat_dim)
        self.subcat_embed = nn.Embedding(num_subcategories, cat_dim)

    def forward(self, embeddings: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        cat = self.cat_embed(embeddings[..., -2].long())
        subcat = self.subcat_embed(embeddings[..., -1].long())
        combined = torch.cat([embeddings[..., :-2], cat, subcat], dim=-1)
        return self.wrapped_model(combined.float(), *args, **kwargs)


class ResizeWrapperModel(nn.Module):
    """A linear bottleneck ``embed_dim -> reduced_dim`` in front of the
    wrapped tower and ``reduced_dim -> embed_dim`` after it."""

    def __init__(self, wrapped: nn.Module, embed_dim: int = EMBEDDING_DIM, reduced_dim: int = REDUCED_DIM):
        super().__init__()
        self.wrapped_model = wrapped
        self.bottleneck_in = nn.Linear(embed_dim, reduced_dim)
        self.bottleneck_out = nn.Linear(reduced_dim, embed_dim)

    def forward(self, embeddings: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return self.bottleneck_out(self.wrapped_model(self.bottleneck_in(embeddings), *args, **kwargs))
