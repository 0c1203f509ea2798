"""Training: the flat-token and padded steps, their losses, the optimizer,
checkpoints and the trainers."""

from .losses import infonce_loss, margin_ranking_loss
from .trainer import ClassificationTrainer, JointTowerTrainer, TowerTrainer, make_optimizer

__all__ = [
    "ClassificationTrainer",
    "JointTowerTrainer",
    "TowerTrainer",
    "infonce_loss",
    "make_optimizer",
    "margin_ranking_loss",
]
