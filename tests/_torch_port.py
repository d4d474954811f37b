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
                         batch_stats=v["batch_stats"], quant=v.get("quant", {}),
                         opt_state=tx.init(v["params"]), rng=jax.random.PRNGKey(0), tx=tx)


def train_batch(k, batch, size, num_classes, seed=100):
    """The k-th synthetic training batch: uint8 NHWC images and labels."""
    rng = np.random.RandomState(seed + k)
    return {"image": rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
            "label": rng.randint(0, num_classes, batch).astype(np.int32)}


GAN_BETA = (0.5, 0.2)  # mean and std of the BN shifts the GAN fixtures draw


def calibrated_gan_variables(model, batch, size, bn_forwards=2, seed=1):
    """Variables of a JAX generator that serve a varied INT8 graph.

    Random init (``PRNGKey(0)``), then each BN shift (``bias_bn``) drawn
    from ``N(GAN_BETA)`` with numpy, so that no ReLU layer is half zeros as
    it is at init. Each BN's running statistics are the mean, over
    ``bn_forwards`` float forwards in train mode, of the batch statistics
    (read back through the momentum update from zeroed statistics). The
    observers then see two QAT forwards in eval mode, so that each is
    calibrated on the folded graph that ``freeze`` serves. Images are
    ``chip_smoke.gan_images`` from ``RandomState(seed + k)``.
    """
    import jax
    import jax.numpy as jnp

    from chip_smoke import gan_images
    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.nn.conv import QConvBNAct

    shape = (batch, size, size, 3)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(model.init)(key, jnp.zeros(shape, jnp.float32))
    rng = np.random.RandomState(seed)

    def shift(path, leaf):
        if getattr(path[-1], "key", None) == "bias_bn":
            return jnp.asarray(rng.normal(*GAN_BETA, leaf.shape).astype(np.float32))
        return leaf

    variables = {**variables, "params": jax.tree_util.tree_map_with_path(
        shift, variables["params"])}
    m = QConvBNAct.bn_momentum
    zeroed = jax.tree.map(jnp.zeros_like, variables["batch_stats"])
    bn_forward = jax.jit(lambda v, xb: model.apply(
        {**v, "batch_stats": zeroed}, xb, mode=fnn_q.FP32, train=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    total = None
    for k in range(bn_forwards):
        stats = jax.tree.map(lambda a: np.asarray(a, np.float64) / m,
                             bn_forward(variables, gan_images(seed + 1 + k, batch, size)))
        total = stats if total is None else jax.tree.map(np.add, total, stats)
    variables = {**variables, "batch_stats": jax.tree.map(
        lambda a: jnp.asarray((a / bn_forwards).astype(np.float32)), total)}
    observe = jax.jit(lambda v, xb: model.apply(v, xb, mode=fnn_q.QAT, train=False,
                                                mutable=["quant"]))
    for k in range(2):
        _, updates = observe(variables, gan_images(seed + 1 + bn_forwards + k, batch, size))
        variables = {**variables, **updates}
    return variables


def jax_layer_codes(model, variables, images):
    """(output, {layer: u8 codes}) of the frozen INT8 graph on ``images``:
    ``freeze``'s program, with the QTensor output of each top-level module
    recorded as an extra output."""
    import flax.linen as fnn
    import jax

    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.quant.qtensor import QTensor

    def fn(x):
        codes = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            path = context.module.scope.path
            if (context.method_name == "__call__" and len(path) == 1
                    and isinstance(out, QTensor)):
                codes[path[0]] = out.q
            return out

        with fnn.intercept_methods(record):
            out = model.apply(variables, x, mode=fnn_q.INT8)
        return out, codes

    out, codes = jax.jit(fn)(images)
    return np.asarray(out), {k: np.asarray(v) for k, v in codes.items()}


@pytest.fixture(scope="module")
def few_threads():
    """Two torch threads for the module: the tier-1 run puts several test
    processes on one host, and torch's thread pools oversubscribe it."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)
