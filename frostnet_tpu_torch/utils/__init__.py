"""Losses, metrics, logging and checkpoints of the classification trainer."""
from .losses import cross_entropy
from .metrics import AverageMeter, topk_accuracy

__all__ = ["cross_entropy", "topk_accuracy", "AverageMeter"]
