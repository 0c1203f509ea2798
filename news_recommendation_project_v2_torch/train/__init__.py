"""Training: the flat-token steps of the latent tower, their losses, the
optimizer, checkpoints and ``TowerTrainer``."""

from .losses import infonce_loss, margin_ranking_loss
from .trainer import TowerTrainer, make_optimizer

__all__ = ["TowerTrainer", "infonce_loss", "make_optimizer", "margin_ranking_loss"]
