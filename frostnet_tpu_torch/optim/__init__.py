"""StatAssist + GradBoost optimizers (SGD and QSGD)."""
from .gradboost import QSGD, SGD, get_optimizer, grouped_weight_decay, set_warmup

__all__ = ["SGD", "QSGD", "get_optimizer", "grouped_weight_decay", "set_warmup"]
