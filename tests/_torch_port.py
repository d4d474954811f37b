"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

The JAX side runs the way the reference serves: ``jax.jit`` closed over its
variables and constants (what ``frostnet_tpu.quant.freeze`` does), so XLA
folds and rewrites the requant arithmetic exactly as in the frozen graph.
Inputs come from numpy seeds and pass between the packages as numpy arrays.
"""
import os

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


def dp_worker(rank, world, store, out, model, size, batch, classes, lr, steps, main_dir):
    """One rank of a data-parallel run on the CPU (gloo, a FileStore at
    ``store``): ``model`` from ``numpy_init(seed 0)`` replicated from rank
    0, then ``steps`` ("FP32" / "QAT") on the global batches
    ``train_batch(k, batch, size, classes)``, each rank its block of rows.
    Writes its variables after each step and the metrics to
    ``out``-``rank``.npz. Then ``classification.main`` (synthetic data, one
    FP32 and one QAT step) into ``main_dir``, its evaluation to
    ``main_dir/result-rank.npz``. Run by tests/test_torch_parallel.py in a
    subprocess per rank."""
    import torch.distributed as dist

    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.nn import FP32, QAT
    from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from frostnet_tpu_torch.parallel import multihost
    from frostnet_tpu_torch.quant import model_variables
    from frostnet_tpu_torch.train import create_train_state, make_train_step

    torch.set_num_threads(2)
    multihost.initialize("cpu", init_method=f"file://{store}", rank=rank, world_size=world)
    mesh = make_mesh()
    tx = get_optimizer("QSGD", lr, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(create_model(model, num_classes=classes, drop_rate=0.0), tx,
                               seed=rank, device="cpu")
    replicate(state.model, mesh)  # rank 1 starts from another seed: the broadcast fixes it
    rec = {}
    for k, name in enumerate(steps):
        mode = {"FP32": FP32, "QAT": QAT}[name]
        if mode is QAT and k and steps[k - 1] != "QAT":
            state.start_qat()
        m = make_train_step(mode, num_classes=classes, mesh=mesh)(
            state, shard_batch(train_batch(k, batch, size, classes), mesh))
        for n, v in m.items():
            rec[f"metrics/{k}/{n}"] = float(v)
        for n, v in model_variables(state.model).items():
            rec[f"step{k}/{n}"] = v.detach().numpy().copy()
    np.savez(f"{out}-{rank}.npz", **rec)
    from frostnet_tpu_torch.train import classification

    cfg = classification.ClassificationConfig(
        model=model, num_classes=classes, image_size=size, batch_size=batch, steps_per_epoch=1,
        fp_epochs=1, epochs=1, learning_rate=lr, device="cpu", save_dir=main_dir)
    state, res = classification.main(cfg)
    np.savez(os.path.join(main_dir, f"result-{rank}.npz"), step=state.step,
             qat_top1=res["qat"]["top1"], qat_loss=res["qat"]["loss"],
             int8_top1=res["int8"]["top1"], int8_loss=res["int8"]["loss"],
             **{k: v.detach().numpy() for k, v in model_variables(state.model).items()})
    dist.destroy_process_group()


def jax_dp_reference(out, model, size, batch, classes, lr, part):
    """JAX's jitted single-device steps (what GSPMD computes on a dp mesh) on
    the global batches of :func:`dp_worker`, from ``numpy_init(seed 0)``:
    part "FP32" runs the FP32 step and writes its state; part "QAT" traces
    and compiles the QAT step meanwhile (on the initial state's shapes),
    then runs it on that state. Each writes the variables after its step and
    the metrics to ``out``.<part>.npz. Run by tests/test_torch_parallel.py
    in two subprocesses beside the ranks."""
    import time

    import conftest  # noqa: F401 - JAX on the CPU, its settings and compile cache
    import jax

    from frostnet_tpu.models import create_model as jax_create_model
    from frostnet_tpu.nn import FP32, QAT
    from frostnet_tpu.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu.train.state import make_train_step
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables

    tree = numpy_init(create_model(model, num_classes=classes), 0)
    jmodel = jax_create_model(model, num_classes=classes, drop_rate=0.0)
    tx = get_optimizer("QSGD", lr, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    js = jax_train_state(jmodel, tree, tx)
    leaves, treedef = jax.tree.flatten(js)
    k = 0 if part == "FP32" else 1
    data = train_batch(k, batch, size, classes)
    step = make_train_step(jmodel, FP32 if k == 0 else QAT, num_classes=classes, donate=False)
    state_file = f"{out}.state.npz"
    if k == 1:
        step.lower(js.start_qat(), data).compile()
        deadline = time.time() + 280
        while not os.path.exists(state_file) and time.time() < deadline:
            time.sleep(0.1)
        saved = np.load(state_file)
        js = jax.tree.unflatten(treedef, [
            jax.numpy.asarray(saved[f"leaf{i}"], dtype=leaf.dtype)
            for i, leaf in enumerate(leaves)]).start_qat()
    js, m = step(js, data)
    if k == 0:
        np.savez(f"{state_file}.tmp.npz", **{f"leaf{i}": np.asarray(v) for i, v in
                                             enumerate(jax.tree.leaves(js))})
        os.replace(f"{state_file}.tmp.npz", state_file)
    rec = {f"metrics/{k}/{n}": float(v) for n, v in m.items()}
    for n, v in flatten_variables(jax.tree.map(np.asarray, js.model_variables)).items():
        rec[f"step{k}/{n}"] = v
    np.savez(f"{out}.{part}.npz", **rec)
