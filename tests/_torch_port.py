"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

The JAX side runs the way the reference serves: ``jax.jit`` closed over its
variables and constants (what ``frostnet_tpu.quant.freeze`` does), so XLA
folds and rewrites the requant arithmetic exactly as in the frozen graph.
Inputs come from numpy seeds and pass between the packages as numpy arrays.
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: the port's kernels run on the GPU only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def calibrated_jax_variables(name, backend, size, num_classes=10, batch=2, seed=0):
    """(model, variables, images): random init + two QAT calibration forwards."""
    import jax
    import jax.numpy as jnp

    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.models import create_model
    from frostnet_tpu.quant import get_qconfig

    model = create_model(name, num_classes=num_classes, qconfig=get_qconfig(backend))
    rng = np.random.RandomState(seed)
    images = rng.randn(batch, size, size, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(model.init)(key, jnp.asarray(images))
    calibrate = jax.jit(lambda v, xb: model.apply(
        v, xb, mode=fnn_q.QAT, train=True, mutable=["batch_stats", "quant"],
        rngs={"dropout": key}))
    for _ in range(2):
        xb = jnp.asarray(rng.randn(batch, size, size, 3).astype(np.float32))
        _, updates = calibrate(variables, xb)
        variables = {**variables, **updates}
    return model, variables, images


def jax_variables(tree):
    """A variables tree of the port (``numpy_init``, or read back from a port
    model) as the JAX package takes it: jnp leaves, JAX ObserverStates."""
    import jax
    import jax.numpy as jnp

    from frostnet_tpu import quant as jq
    from frostnet_tpu_torch.quant import ObserverState

    def obs(node):
        if isinstance(node, ObserverState):
            return jq.ObserverState(jnp.asarray(node.min_val), jnp.asarray(node.max_val))
        if isinstance(node, dict):
            return {k: obs(v) for k, v in node.items()}
        return jnp.asarray(node)

    return {col: obs(tree[col]) for col in ("params", "batch_stats", "quant") if col in tree}


def jax_train_state(model, tree, tx):
    """A JAX QATTrainState on the variables ``tree`` (port layout)."""
    import jax
    import jax.numpy as jnp

    from frostnet_tpu.train.state import QATTrainState

    v = jax_variables(tree)
    return QATTrainState(step=jnp.zeros([], jnp.int32), params=v["params"],
                         batch_stats=v["batch_stats"], quant=v["quant"],
                         opt_state=tx.init(v["params"]), rng=jax.random.PRNGKey(0), tx=tx)


def train_batch(k, batch, size, num_classes, seed=100):
    """The k-th synthetic training batch: uint8 NHWC images and labels."""
    rng = np.random.RandomState(seed + k)
    return {"image": rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
            "label": rng.randint(0, num_classes, batch).astype(np.int32)}
