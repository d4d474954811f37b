"""Host ms a request until the predictor call returns (before the response
is copied to the host), the mean over the traced run's requests outside the
profiled stretch. Layer: ``serve.py``'s predictors and the kernel wrappers.
Moves ``serve_p95_ms``."""
from portbench.readers import host_ms as read  # noqa: F401
