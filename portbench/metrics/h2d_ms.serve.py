"""Device ms a request of copies from the host to the card: the request's
float32 images going in. Moves ``serve_p95_ms``."""
from portbench.readers import copies_ms


def read(m):
    return copies_ms(m, "HtoD")
