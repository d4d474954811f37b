"""Training traffic on a classifier of the port's model registry: the QAT
step of ``train/state.py::make_train_step``, cross-entropy on uniform
labels (``drivers/training.py`` has the rest)."""
from portbench.drivers.training import Hooks, Training

DRIVER = Training(Hooks())
run = DRIVER.run
