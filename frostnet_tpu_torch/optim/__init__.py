"""Optimizers (StatAssist + GradBoost) and LR schedules."""
from . import schedules
from .gradboost import (QSGD, RMS, RMSTF, SGD, Adam, AdamW, EmaState, QAdam, QAdamN, QAdamW,
                        QRMS, ema_update, get_optimizer, grouped_weight_decay, learning_rate,
                        param_ema, set_warmup)
from .schedules import ReduceLROnPlateau, get_lr_scheduler

__all__ = ["SGD", "QSGD", "RMS", "QRMS", "RMSTF", "Adam", "QAdam", "AdamW", "QAdamW",
           "QAdamN", "get_optimizer", "grouped_weight_decay", "set_warmup", "learning_rate",
           "param_ema", "EmaState", "ema_update", "schedules", "get_lr_scheduler",
           "ReduceLROnPlateau"]
