"""Serving traffic on a classifier of the port's model registry:
``serve.Int8Predictor`` (the fused Frost block where the traffic asks),
the logits back on the host, compared whole (``drivers/serving.py`` has
the rest)."""
from portbench.drivers.serving import Hooks, Serving

DRIVER = Serving(Hooks())
run = DRIVER.run
