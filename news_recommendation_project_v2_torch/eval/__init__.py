"""Evaluation: the MIND metrics on the host (``metrics``) and on the device
(``device_metrics``), and score composition (``ranker``)."""

from .metrics import auc_score, dcg_score, mrr_score, ndcg_score, score, score_batch, score_row

__all__ = ["auc_score", "dcg_score", "mrr_score", "ndcg_score", "score", "score_batch", "score_row"]
