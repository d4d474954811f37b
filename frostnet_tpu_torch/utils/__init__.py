"""Losses and metrics of the classification train step."""
from .losses import cross_entropy
from .metrics import topk_accuracy

__all__ = ["cross_entropy", "topk_accuracy"]
