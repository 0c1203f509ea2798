"""Training: the flat-token, padded and end-to-end steps, their losses, the
optimizer, checkpoints and the trainers."""

from .losses import infonce_loss, margin_ranking_loss
from .trainer import ClassificationTrainer, EndToEndTrainer, JointTowerTrainer, TowerTrainer, make_optimizer

__all__ = [
    "ClassificationTrainer",
    "EndToEndTrainer",
    "JointTowerTrainer",
    "TowerTrainer",
    "infonce_loss",
    "make_optimizer",
    "margin_ranking_loss",
]
