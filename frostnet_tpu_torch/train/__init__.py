"""Training: state, train and eval steps (StatAssist warm-up, QAT, QAT_FROZEN)."""
from .state import (TrainState, create_train_state, make_eval_step, make_train_step,
                    prep_image, recalibrate)

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step",
           "recalibrate", "prep_image"]
