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


MP_SIZE, MP_BATCH, MP_CLASSES = 16, 8, 8  # test_multihost._mp_run's settings
# (name, drop_rate, noise_decay, backend): "noisy" keeps JAX's settings
# (dropout 0.2, GradBoost noise on); "quiet" has neither, for the comparison
# with JAX, whose dropout and noise draw from other generators; "fbgemm"
# is "noisy" with per-channel weight observers
MP_CASES = (("noisy", 0.2, 1e-2, "qnnpack"), ("quiet", 0.0, 1.0, "qnnpack"),
            ("fbgemm", 0.2, 1e-2, "fbgemm"))


def mp_model(drop_rate, backend="qnnpack"):
    from frostnet_tpu_torch.models import FrostNet
    from frostnet_tpu_torch.quant import get_qconfig

    return FrostNet(mode="tiny", width_mult=1.0, quantized=True, num_classes=MP_CLASSES,
                    drop_rate=drop_rate, qconfig=get_qconfig(backend))


def mp_batch():
    """``_mp_run``'s batch."""
    rng = np.random.RandomState(1)
    return {"image": (0.5 * rng.randn(MP_BATCH, MP_SIZE, MP_SIZE, 3)).astype(np.float32),
            "label": rng.randint(0, MP_CLASSES, MP_BATCH).astype(np.int32)}


def mp_warm_tree(path, backend="qnnpack"):
    """A warm QAT state (five steps from ``numpy_init(seed 0)``, as
    ``_warm_state`` warms JAX's), written to ``path`` as flat JAX keys."""
    from frostnet_tpu_torch.nn import QAT
    from frostnet_tpu_torch.optim import get_optimizer
    from frostnet_tpu_torch.quant import model_variables
    from frostnet_tpu_torch.train import create_train_state, make_train_step

    state = create_train_state(mp_model(0.0, backend), get_optimizer("QSGD", 1e-3), seed=0,
                               device="cpu")
    state.start_qat()
    step = make_train_step(QAT, num_classes=MP_CLASSES)
    rng = np.random.RandomState(7)
    for _ in range(5):
        step(state, {"image": (0.5 * rng.randn(8, 16, 16, 3)).astype(np.float32),
                     "label": rng.randint(0, 8, 8).astype(np.int32)})
    np.savez(path, **{k: v.detach().numpy() for k, v in model_variables(state.model).items()})


def mp_warm_path(warm_dir, backend):
    return os.path.join(warm_dir, f"warm-{backend}.npz")


def mp_step(warm, drop_rate, noise_decay, mesh=None, backend="qnnpack"):
    """One QAT step from the warm state and a QAT_FROZEN forward: on one
    process, or this rank's part under ``mesh`` (its parameters sharded
    when ``mesh.mp > 1``). Returns the loss, the eval logits and every
    variable (the full ones, gathered)."""
    import torch

    from frostnet_tpu_torch.nn import QAT, QAT_FROZEN
    from frostnet_tpu_torch.optim import get_optimizer
    from frostnet_tpu_torch.parallel import gather_mp, shard_batch, shard_params_for_mp
    from frostnet_tpu_torch.quant import model_variables
    from frostnet_tpu_torch.quant.export import unflatten_variables
    from frostnet_tpu_torch.train import create_train_state, make_train_step

    tx = get_optimizer("QSGD", 1e-3, noise_decay=noise_decay)
    state = create_train_state(mp_model(drop_rate, backend), tx, seed=0, device="cpu",
                               variables=unflatten_variables(dict(np.load(warm))))
    state.start_qat()
    if mesh is not None:
        shard_params_for_mp(state.model, mesh)
    batch = mp_batch()
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    m = make_train_step(QAT, num_classes=MP_CLASSES, mesh=mesh)(state, batch)
    with torch.no_grad():
        logits = state.model(torch.as_tensor(batch["image"]), mode=QAT_FROZEN)
    with gather_mp(state.model):
        flat = {k: v.detach().numpy().copy() for k, v in model_variables(state.model).items()}
    return float(m["loss"]), logits.numpy(), flat


def mp_worker(rank, world, mp, store, out, warm, main_dir=None):
    """One rank of a ``dp x mp`` run on the CPU (gloo, a FileStore):
    :func:`mp_step` for each of :data:`MP_CASES` from the warm states in
    the directory ``warm``, written to
    ``out``-``rank``.npz; with ``main_dir``, then ``classification.main``
    with ``mp`` (synthetic data, one FP32 and one QAT step) into it, its
    evaluation to ``main_dir/result-rank.npz``. Run by
    tests/test_torch_mp.py in a subprocess per rank."""
    import torch
    import torch.distributed as dist

    from frostnet_tpu_torch.parallel import make_mesh, multihost
    from frostnet_tpu_torch.quant import model_variables

    torch.set_num_threads(1)
    multihost.initialize("cpu", init_method=f"file://{store}", rank=rank, world_size=world)
    mesh = make_mesh(mp=mp)
    rec = {}
    for name, drop, noise, backend in MP_CASES:
        loss, logits, flat = mp_step(mp_warm_path(warm, backend), drop, noise, mesh, backend)
        rec[f"{name}/loss"], rec[f"{name}/logits"] = loss, logits
        rec.update({f"{name}/{k}": v for k, v in flat.items()})
    np.savez(f"{out}-{rank}.npz", **rec)
    if main_dir is not None:
        from frostnet_tpu_torch.train import classification

        cfg = classification.ClassificationConfig(
            model="frostnet_quant_small_0_35", num_classes=10, image_size=32, batch_size=4,
            steps_per_epoch=1, fp_epochs=1, epochs=1, device="cpu", save_dir=main_dir, mp=mp)
        state, res = classification.main(cfg)
        np.savez(os.path.join(main_dir, f"result-{rank}.npz"), step=state.step,
                 qat_loss=res["qat"]["loss"], int8_loss=res["int8"]["loss"],
                 **{k: v.detach().numpy() for k, v in model_variables(state.model).items()})
    dist.destroy_process_group()


def jax_mp_reference(out, warm, mp):
    """JAX's "quiet" step of :data:`MP_CASES` on a ``(dp 1, mp)`` mesh of
    CPU devices, ``shard_params_for_mp`` as ``test_multihost._mp_run``
    applies it, from the warm state of :func:`mp_warm_tree`: the loss, the
    QAT_FROZEN logits and every variable, to ``out``. Run by
    tests/test_torch_mp.py in a subprocess."""
    import conftest  # noqa: F401 - JAX on the CPU, its settings and compile cache
    import jax

    from frostnet_tpu.models.frostnet import FrostNet
    from frostnet_tpu.nn import QAT, QAT_FROZEN
    from frostnet_tpu.optim import get_optimizer
    from frostnet_tpu.parallel import make_mesh, replicate, shard_batch, shard_params_for_mp
    from frostnet_tpu.train import make_train_step
    from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables

    mesh = make_mesh(dp=1, mp=mp, devices=jax.devices()[:mp])
    model = FrostNet(mode="tiny", width_mult=1.0, quantized=True, num_classes=MP_CLASSES,
                     drop_rate=0.0)
    tx = get_optimizer("QSGD", 1e-3, noise_decay=1.0)
    tree = unflatten_variables(dict(np.load(mp_warm_path(warm, "qnnpack"))))
    state = jax_train_state(model, tree, tx).start_qat()
    state = state.replace(params=shard_params_for_mp(state.params, mesh),
                          batch_stats=replicate(state.batch_stats, mesh),
                          quant=replicate(state.quant, mesh),
                          opt_state=replicate(state.opt_state, mesh))
    batch = shard_batch(mp_batch(), mesh)
    with mesh:
        state, m = make_train_step(model, QAT, num_classes=MP_CLASSES, donate=False)(state,
                                                                                     batch)
        logits = model.apply({"params": state.params, "batch_stats": state.batch_stats,
                              "quant": state.quant}, batch["image"], mode=QAT_FROZEN)
    rec = {"quiet/loss": float(m["loss"]), "quiet/logits": np.asarray(logits)}
    for n, v in flatten_variables(jax.tree.map(np.asarray, state.model_variables)).items():
        rec[f"quiet/{n}"] = v
    np.savez(out, **rec)


# the trainers' two-rank runs of tests/test_torch_trainers_dp.py: small
# widths and sizes, one step a phase (``gan_idle``: batch 1 on two ranks,
# so dp 1 and rank 1 idle)
TRAINER_RUNS = {
    "seg": ("segmentation", dict(model="mobilenetv3_RE_small", dataset="synthetic",
                                 crop_size=48, batch_size=4, steps_per_epoch=1, fp_epochs=1,
                                 epochs=1)),
    "det": ("detection", dict(net_type="qssd", dataset="synthetic", batch_size=4,
                              warmup_iters=1, max_iter=2)),
    "pix2pix": ("gan", dict(model="pix2pix", netG="resnet_6blocks", ngf=8, ndf=8,
                            crop_size=32, batch_size=2, steps_per_epoch=1, fp_epochs=1,
                            epochs=1, save_epoch_freq=1)),
    "cyclegan": ("gan", dict(model="cycle_gan", netG="resnet_6blocks", ngf=8, ndf=8,
                             crop_size=32, batch_size=2, steps_per_epoch=1, fp_epochs=1,
                             epochs=1, save_epoch_freq=1, pool_size=2)),
    "gan_idle": ("gan", dict(model="pix2pix", netG="resnet_6blocks", ngf=8, ndf=8,
                             crop_size=32, batch_size=1, steps_per_epoch=1, fp_epochs=1,
                             epochs=1, save_epoch_freq=1)),
}


# each trainer module's step factories (the first step of a pair runs first)
TRAINER_STEPS = {"segmentation": ("make_seg_train_step",), "detection": ("make_det_train_step",),
                 "gan": ("make_pix2pix_steps", "make_cyclegan_steps")}


class _StepCapture:
    """Patches a trainer module's step factories for a run: each training
    iteration records into ``capture`` its mode (``"qat"`` flags), its
    global batch as numpy (``"batches"``) and, before the first, every
    net's variables (``"init"``, flat, in the order the step takes the
    nets)."""

    def __init__(self, module, names, capture):
        self.mod, self.capture = module, capture
        self.saved = {n: getattr(module, n) for n in names}
        capture.update(qat=[], batches=[])

    def _record(self, mode, args):
        from frostnet_tpu_torch.quant import model_variables

        cap = self.capture
        if "init" not in cap:
            cap["init"] = [{k: v.detach().cpu().numpy().copy()
                            for k, v in model_variables(a.model).items()}
                           for a in args if hasattr(a, "model")]
        batch = next(a for a in args if isinstance(a, dict))
        cap["qat"].append(bool(mode.fake_quant))
        cap["batches"].append({k: torch.as_tensor(v).cpu().numpy().copy()
                               for k, v in batch.items()})

    def _factory(self, make):
        def factory(mode, *a, **kw):
            out = make(mode, *a, **kw)
            first = out[0] if isinstance(out, tuple) else out

            def step(*args):
                self._record(mode, args)
                return first(*args)
            return (step, *out[1:]) if isinstance(out, tuple) else step
        return factory

    def __enter__(self):
        for n, make in self.saved.items():
            setattr(self.mod, n, self._factory(make))

    def __exit__(self, *exc):
        for n, make in self.saved.items():
            setattr(self.mod, n, make)


def run_trainer(kind, save_dir, capture=None):
    """``main`` of the trainer of :data:`TRAINER_RUNS` ``kind`` on the CPU
    into ``save_dir``: its record (every final variable under
    ``<net>/<key>``, the FP32 warm-up's losses under ``fp32/<i>`` and the
    QAT phase's under ``qat/<i>``), or None on an idle rank. With
    ``capture`` (a dict) each iteration's global batch and mode, the nets'
    variables before the first and the losses' names (``"losses"``: tag
    and metric, in the record's order) are recorded into it
    (:func:`jax_trainer_steps` takes it)."""
    import contextlib
    import importlib

    from frostnet_tpu_torch.quant import model_variables

    pkg, kw = TRAINER_RUNS[kind]
    train = importlib.import_module(f"frostnet_tpu_torch.{pkg}.train")
    rec = {}
    with (_StepCapture(train, TRAINER_STEPS[pkg], capture) if capture is not None
          else contextlib.nullcontext()):
        if pkg == "segmentation":
            state, res = train.main(train.SegConfig(save_dir=save_dir, device="cpu", **kw))
            nets = {"net": state.model}
            losses = [(h["tag"], "loss", v) for h in res["history"] for v in h["losses"]]
            rec["miou/qat"], rec["miou/int8"] = res["qat"]["miou"], res["int8"]["miou"]
        elif pkg == "detection":
            state, res = train.main(train.DetConfig(save_dir=save_dir, device="cpu", **kw))
            if state is None:
                return None
            nets = {"net": state.model}
            losses = [(h["tag"], "loss", h["loss"]) for h in res["history"]]
        else:
            gs, ds, res = train.main(train.GANConfig(save_dir=save_dir, device="cpu", **kw))
            if res.get("idle"):
                return None
            nets = {f"g{i}": s.model for i, s in enumerate(gs)}
            nets.update({f"d{i}": s.model for i, s in enumerate(ds)})
            losses = [(r["tag"], k, v) for r in res["history"] for k in sorted(r["losses"])
                      for v in r["losses"][k]]
    for name, model in nets.items():
        rec.update({f"{name}/{k}": v.detach().numpy().copy()
                    for k, v in model_variables(model).items()})
    rec.update(_loss_record(losses))
    if capture is not None:
        capture["losses"] = [(tag == "fp_warmup", k) for tag, k, _ in losses]
    return rec


def _loss_record(losses):
    """``fp32/<i>`` and ``qat/<i>`` of (tag, metric, value) triples in order."""
    rec = {}
    for phase in ("fp32", "qat"):
        mine = [v for tag, _, v in losses if (tag == "fp_warmup") == (phase == "fp32")]
        rec.update({f"{phase}/{i}": v for i, v in enumerate(mine)})
    return rec


def _compile_all(jobs):
    """{name: (jitted function, example arguments)} -> {name: its
    executable}, compiled on threads at once (XLA compiles with the GIL
    released)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as pool:
        done = {n: pool.submit(lambda f, a: f.lower(*a).compile(), f, a)
                for n, (f, a) in jobs.items()}
        return {n: d.result() for n, d in done.items()}


def jax_trainer_steps(kind, capture):
    """JAX's jitted single-device steps (what GSPMD computes on the
    trainer's mesh) of the trainer of :data:`TRAINER_RUNS` ``kind``: from
    the variables and on the global batches ``capture`` holds
    (:func:`run_trainer`), each step in its mode, with the optimizers, the
    warm-up's end and (CycleGAN) the image pools that JAX's trainer builds
    from the same settings. Every step function is compiled first, all at
    once. Returns its record in :func:`run_trainer`'s layout."""
    import jax
    import jax.numpy as jnp

    from frostnet_tpu.nn import FP32 as J_FP32, QAT as J_QAT
    from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables

    pkg, kw = TRAINER_RUNS[kind]
    trees = [unflatten_variables(flat) for flat in capture["init"]]
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in capture["batches"]]
    qat = capture["qat"]
    if qat != sorted(qat) or not any(qat) or all(qat):
        raise AssertionError(f"expected FP32 steps, then QAT ones: {qat}")
    first_qat = qat.index(True)
    losses, nets = [], {}

    def modes():  # (JAX mode, this step's batch, the warm-up ends before it)
        for i, (q, b) in enumerate(zip(qat, batches)):
            yield J_QAT if q else J_FP32, b, i == first_qat

    if pkg == "segmentation":
        from frostnet_tpu.optim import get_lr_scheduler, get_optimizer, grouped_weight_decay
        from frostnet_tpu.segmentation import train as jt
        from frostnet_tpu.segmentation.models import get_seg_model

        cfg = jt.resolve_dataset_defaults(jt.SegConfig(**kw))
        total = (cfg.fp_epochs + cfg.epochs) * cfg.steps_per_epoch
        sched_kw = {"power": cfg.power} if cfg.scheduler == "poly" else {}
        tx = get_optimizer(cfg.optim, get_lr_scheduler(cfg.scheduler, base_lr=cfg.learning_rate,
                                                       total_steps=total, **sched_kw),
                           weight_decay=grouped_weight_decay(cfg.weight_decay),
                           **({"clip_by": cfg.clip_by} if cfg.optim.startswith("Q") else {}))
        model = get_seg_model(cfg.model, num_classes=cfg.num_classes,
                              dataset="pascal" if cfg.dataset in ("pascal", "custom")
                              else "city")
        weights = jt.CITYSCAPES_CLASS_WEIGHTS if cfg.dataset == "city" else None
        state = jax_train_state(model, trees[0], tx)
        step = _compile_all({m: (jt.make_seg_train_step(model, m, weights, cfg.ignore_index,
                                                        cfg.num_classes, loss_type=cfg.loss_type),
                                 (state.start_qat() if m is J_QAT else state,
                                  batches[first_qat if m is J_QAT else 0]))
                             for m in (J_FP32, J_QAT)})
        for mode, batch, ends in modes():
            state = state.start_qat() if ends else state
            state, m = step[mode](state, batch)
            losses.append((mode is J_FP32, {"loss": m["loss"]}))
        nets["net"] = state.model_variables
    elif pkg == "detection":
        from frostnet_tpu.detection import train as jt
        from frostnet_tpu.detection.anchors import make_priors
        from frostnet_tpu.detection.models import build_ssd
        from frostnet_tpu.optim import get_optimizer, schedules, set_warmup
        from frostnet_tpu_torch.detection.models import join_variables, split_variables

        cfg = jt.DetConfig(**kw)
        det_cfg = jt.select_config(cfg.net_type, cfg.dataset)
        classes = cfg.num_classes or det_cfg["num_classes"]
        feat, head = build_ssd(num_classes=classes)
        priors = jnp.asarray(make_priors(det_cfg))
        tx = get_optimizer(cfg.optim, schedules.multistep(cfg.lr, det_cfg["lr_steps"], cfg.gamma),
                           momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                           **({"clip_by": cfg.clip_by} if cfg.optim.startswith("Q") else {}))
        fv, hv = (jax_variables(t) for t in split_variables(trees[0]))
        state = jt.DetState(step=jnp.zeros([], jnp.int32), feat_params=fv["params"],
                            feat_batch_stats=fv["batch_stats"], feat_quant=fv.get("quant", {}),
                            head_params=hv["params"], head_batch_stats=hv["batch_stats"],
                            opt_state=tx.init((fv["params"], hv["params"])),
                            rng=jax.random.PRNGKey(0), tx=tx)

        def warm_done(st):
            return st.replace(opt_state=set_warmup(st.opt_state, False))

        step = _compile_all({m: (jt.make_det_train_step(feat, head, m, priors, classes),
                                 (warm_done(state) if m is J_QAT else state,
                                  batches[first_qat if m is J_QAT else 0]))
                             for m in (J_FP32, J_QAT)})
        for mode, batch, ends in modes():
            state = warm_done(state) if ends else state
            state, m = step[mode](state, batch)
            losses.append((mode is J_FP32, {"loss": m["loss"]}))
        nets["net"] = join_variables(
            {"params": state.feat_params, "batch_stats": state.feat_batch_stats,
             "quant": state.feat_quant},
            {"params": state.head_params, "batch_stats": state.head_batch_stats})
    else:
        from frostnet_tpu.gan import models as jm
        from frostnet_tpu.gan import networks as jn
        from frostnet_tpu.gan import train as jt
        from frostnet_tpu.gan.image_pool import ImagePool
        from frostnet_tpu.optim import adam, set_warmup

        cfg = jt.GANConfig(**kw)
        lr = jt._gan_lr_schedule(cfg, cfg.steps_per_epoch)

        def net_state(tree, tx):
            v = jax_variables(tree)
            return jm.NetState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                               quant=v.get("quant", {}), opt_state=tx.init(v["params"]), tx=tx)

        def variables(st):
            return {"params": st.params, "batch_stats": st.batch_stats, "quant": st.quant}

        g_tx, d_tx = jt._g_optimizer(cfg, lr), adam(lr, b1=cfg.beta1)
        if cfg.model == "pix2pix":
            net_g = jn.define_g(ngf=cfg.ngf, netG=cfg.netG, quantized=True)
            net_d = jn.define_d(ndf=cfg.ndf, netD=cfg.netD, n_layers=cfg.n_layers_d,
                                norm=cfg.norm or "batch")
            g, d = net_state(trees[0], g_tx), net_state(trees[1], d_tx)

            def warm_done(st):
                return st.replace(opt_state=set_warmup(st.opt_state, False))

            jobs = {}
            for m in (J_FP32, J_QAT):
                d_step, g_step = jm.make_pix2pix_steps(net_g, net_d, m, cfg.gan_mode,
                                                       cfg.lambda_l1)
                args = (warm_done(g) if m is J_QAT else g, d,
                        batches[first_qat if m is J_QAT else 0])
                jobs.update({(m, "d"): (d_step, args), (m, "g"): (g_step, args)})
            step = _compile_all(jobs)
            for mode, batch, ends in modes():
                g = warm_done(g) if ends else g
                d, md = step[mode, "d"](g, d, batch)
                g, mg = step[mode, "g"](g, d, batch)
                losses.append((mode is J_FP32, {**md, **mg}))
            nets.update(g0=variables(g), d0=variables(d))
        else:
            gens = [jn.define_g(ngf=cfg.ngf, netG=cfg.netG, quantized=True) for _ in range(2)]
            diss = [jn.define_d(ndf=cfg.ndf, netD=cfg.netD, n_layers=cfg.n_layers_d,
                                norm=cfg.norm or "none") for _ in range(2)]
            ga, gb = (net_state(t, g_tx) for t in trees[:2])
            da, db = (net_state(t, d_tx) for t in trees[2:])
            joint = g_tx.init((ga.params, gb.params))
            pool_a, pool_b = ImagePool(cfg.pool_size, cfg.seed), ImagePool(cfg.pool_size,
                                                                           cfg.seed + 1)
            jobs = {}
            for m in (J_FP32, J_QAT):
                g_step, d_step = jm.make_cyclegan_steps(*gens, *diss, m, cfg.gan_mode,
                                                        cfg.lambda_a, cfg.lambda_b,
                                                        cfg.lambda_idt)
                b = batches[first_qat if m is J_QAT else 0]
                jobs[m, "g"] = (g_step, (ga, gb, da, db, b,
                                         set_warmup(joint, False) if m is J_QAT else joint))
                jobs[m, "d"] = (d_step, (da, b["B"], b["A"]))
            step = _compile_all(jobs)
            for mode, batch, ends in modes():
                joint = set_warmup(joint, False) if ends else joint
                ga, gb, joint, fake_a, fake_b, m = step[mode, "g"](ga, gb, da, db, batch, joint)
                da, m["loss_D_A"] = step[mode, "d"](
                    da, batch["B"], jnp.asarray(pool_b.query(np.asarray(fake_b))))
                db, m["loss_D_B"] = step[mode, "d"](
                    db, batch["A"], jnp.asarray(pool_a.query(np.asarray(fake_a))))
                losses.append((mode is J_FP32, m))
            nets.update(g0=variables(ga), g1=variables(gb), d0=variables(da),
                        d1=variables(db))
    names = [(fp32, k) for fp32, m in losses for k in sorted(m)]
    if names != capture["losses"]:
        raise AssertionError(f"JAX's losses {names} are not the trainer's {capture['losses']}")
    rec = _loss_record([("fp_warmup" if fp32 else "qat", k, float(m[k]))
                        for fp32, m in losses for k in sorted(m)])
    for name, v in nets.items():
        rec.update({f"{name}/{k}": a for k, a in flatten_variables(
            jax.tree.map(np.asarray, v)).items()})
    return rec


def trainer_reference_worker(kind, out):
    """The one-process run of the trainer of :data:`TRAINER_RUNS` ``kind``
    on the CPU (one thread, as each rank has) into ``out/one/<kind>``, its
    record to ``out/one-<kind>.npz``; then JAX's steps on its global
    batches (:func:`jax_trainer_steps`), their record to
    ``out/jax-<kind>.npz``. Run by tests/test_torch_trainers_dp.py in a
    subprocess per kind, beside the ranks."""
    import conftest  # noqa: F401 - JAX on the CPU, its settings and compile cache

    torch.set_num_threads(1)
    capture = {}
    np.savez(os.path.join(out, f"one-{kind}.npz"),
             **run_trainer(kind, os.path.join(out, "one", kind), capture))
    np.savez(os.path.join(out, f"jax-{kind}.npz"), **jax_trainer_steps(kind, capture))


def trainer_worker(rank, world, store, out):
    """One rank of every run of :data:`TRAINER_RUNS` in turn, on the CPU
    (gloo, a FileStore at ``store``): each into ``out/<kind>``, its record
    to ``out/<kind>-<rank>.npz`` (none on an idle rank); then the
    segmentation evaluator on the seg run's checkpoint, its dual mIoU to
    ``out/seg_eval-<rank>.npz``. Run by tests/test_torch_trainers_dp.py in
    a subprocess per rank."""
    import torch
    import torch.distributed as dist

    from frostnet_tpu_torch.parallel import multihost
    from frostnet_tpu_torch.segmentation import evaluate

    torch.set_num_threads(1)
    multihost.initialize("cpu", init_method=f"file://{store}", rank=rank, world_size=world)
    for kind in TRAINER_RUNS:
        rec = run_trainer(kind, os.path.join(out, kind))
        if rec is not None:
            np.savez(os.path.join(out, f"{kind}-{rank}.npz"), **rec)
    res = evaluate.main(seg_eval_args(os.path.join(out, "seg")))
    np.savez(os.path.join(out, f"seg_eval-{rank}.npz"), qat=res["qat"], int8=res["int8"],
             cm=res["int8_eval"]["cm"])
    dist.destroy_process_group()


def seg_eval_args(run_dir):
    """The segmentation evaluator's arguments on the checkpoint of the
    ``seg`` run in ``run_dir``."""
    from frostnet_tpu_torch.segmentation import evaluate

    kw = TRAINER_RUNS["seg"][1]
    return evaluate.build_parser().parse_args(
        ["--model", kw["model"], "--checkpoint", os.path.join(run_dir, "checkpoint"),
         "--crop_size", str(kw["crop_size"]), "--batch_size", str(kw["batch_size"]),
         "--device", "cpu"])
