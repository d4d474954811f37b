"""PyTorch port, the rest of the classification zoo, against JAX.

The same variables and inputs, made from numpy seeds, go through the JAX
model and the port's:

* The registry: every JAX name that is not a FrostNet, MobileNet or ResNet
  (45: ShuffleNetV2, VGG, AlexNet, the float-only baselines, the CIFAR
  models, the ESPNetv2 classifiers) builds in the port with JAX's
  variables, name for name and shape for shape (``jax.eval_shape`` of
  ``init`` at the size the port's head is built for).
* ``channel_shuffle`` on codes: an exact permutation, equal to JAX's.
* INT8: ``qshufflenet_v2_x0_5`` (64x64, qnnpack and fbgemm), ``qvgg11_bn``
  (32x32), ``qalexnet`` (64x64) and ``cifar_alexnet`` (32x32), BN shifts
  drawn, calibrated in JAX (two QAT forwards in train mode): the codes of
  every module of the port's frozen graph equal JAX ``freeze()``'s, and the
  logits too, bit for bit.
* Training: one FP32 step, one QAT step and a QAT_FROZEN eval step of each
  of those models against the jitted JAX steps, in the bands of
  ``tests/test_torch_train_step.py`` (lr 1e-3, no dropout).
* The float-only baselines (small DenseNet, SqueezeNet 1.1, MNASNet 0.5,
  Inception-v3 at 139x139): the FP32 eval forward within ``FLOAT_REL``, and
  one SGD step's loss within ``FP32_LOSS_REL`` (relative 1e-5) and its
  update within ``UPDATE_REL`` (Inception-v3: ``INCEPTION_UPDATE_REL``, its
  ill-conditioned backward at init). The JAX models take no ``mode`` (a
  ``TypeError``); the port raises ``TypeError`` in QAT, QAT_FROZEN and INT8.
* The ESPNetv2 classifier: INT8 raises in both packages (JAX's
  ``level5_0`` feeds its reinforcement a float); the FP32 and QAT train
  forwards move that reinforcement's BN statistics and observers as JAX's
  do (one value a channel, variance 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_train_state, jax_variables, train_batch  # noqa: F401
from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu.models import create_model as jax_create_model
from frostnet_tpu.models import fp_only as jfp
from frostnet_tpu.models import list_models as jax_list_models
from frostnet_tpu.models import shufflenetv2 as jshuffle
from frostnet_tpu.optim import get_optimizer as jax_optimizer
from frostnet_tpu.optim import grouped_weight_decay as jax_gwd
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu.train.state import make_eval_step as jax_eval_step
from frostnet_tpu.train.state import make_train_step as jax_train_step
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.models import create_model, fp_only, shufflenetv2
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import (QTensor, freeze, from_jax_variables, get_qconfig,
                                      model_variables, numpy_init)
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
from frostnet_tpu_torch.segmentation.espnet import CLASSIFIER_INT8
from frostnet_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from test_torch_mobilenet_train import FLOAT_REL, UPDATE_REL
from test_torch_train_step import FP32_LOSS_REL, QAT_LOSS_REL

pytestmark = pytest.mark.usefixtures("few_threads")
CLASSES = 10
OLD_FAMILIES = ("frostnet_", "mobilenet_v2", "mobilenet_v3", "qmobilenet_v2", "qmobilenet_v3",
                "resnet", "qresnet", "resnext", "qresnext")
ZOO = sorted(n for n in jax_list_models() if not n.startswith(OLD_FAMILIES))


def head_size(name: str) -> int:
    """The input size the port builds a model's head for by default (VGG
    and AlexNet size ``fc0`` from it), and a size the JAX model traces at."""
    if name == "cifar_alexnet":
        return 32
    if "vgg" in name or "alexnet" in name:
        return 224
    return 299 if name == "inception_v3" else 64


def _flat_shapes(shapes):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        key = (f"quant/{'/'.join(names[1:-1])}.{names[-1]}" if names[0] == "quant"
               else "/".join(names))
        out[key] = tuple(leaf.shape)
    return out


def test_zoo_is_every_other_jax_name():
    assert len(ZOO) == 45 and len(jax_list_models()) == 101


@pytest.mark.parametrize("name", ZOO)
def test_variables_match_jax(name):
    """Every variable of the JAX model, by name and shape, and no other."""
    port = create_model(name)
    mine = {k: tuple(v.shape) for k, v in model_variables(port).items()}
    assert mine == _flat_shapes(jax.eval_shape(
        jax_create_model(name).init, jax.random.PRNGKey(0),
        jnp.zeros((1, head_size(name), head_size(name), 3), jnp.float32)))
    quantized = name.startswith(("q", "espnetv2", "cifar_"))
    assert any(k.startswith("quant/") for k in mine) == quantized


def test_image_size_sizes_the_dense_head():
    """``create_model(..., image_size=)`` (the CLIs pass theirs) sizes VGG's
    and AlexNet's ``fc0``; other models ignore it."""
    assert create_model("qvgg11", image_size=32).fc0.in_features == 512
    assert create_model("alexnet", image_size=224).fc0.in_features == 256 * 6 * 6
    assert create_model("cifar_vgg16_bn", image_size=32).fc0.in_features == 512
    assert create_model("cifar_alexnet").fc0.in_features == 256 * 7 * 7
    assert create_model("qshufflenet_v2_x0_5", image_size=32).fc.in_features == 1024
    with pytest.raises(ValueError, match="FrostNet-only"):
        create_model("qvgg11", fuse_int8=True)


@pytest.mark.parametrize("c", [8, 48, 116])
def test_channel_shuffle_is_jax_permutation(c):
    q = np.random.RandomState(c).randint(0, 256, (2, 5, 3, c)).astype(np.uint8)
    want = np.asarray(jshuffle.channel_shuffle(JQTensor(jnp.asarray(q), 0.1, 3), 2).q)
    got = shufflenetv2.channel_shuffle(QTensor(torch.as_tensor(q), None, None), 2).q.numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got[0, 0, 0]) == sorted(q[0, 0, 0])


# ---------------------------------------------------------------------------
# INT8 against JAX freeze()
# ---------------------------------------------------------------------------

# (name, size, backend)
INT8_CASES = [("qshufflenet_v2_x0_5", 64, "qnnpack"), ("qshufflenet_v2_x0_5", 64, "fbgemm"),
              ("qvgg11_bn", 32, "qnnpack"), ("qalexnet", 64, "qnnpack"),
              ("cifar_alexnet", 32, "qnnpack")]


def shifted_tree(model, seed: int = 1):
    """``numpy_init(model, 0)`` with each BN shift drawn from N(0.5, 0.5) and
    each conv bias from N(0.1, 0.2) (``RandomState(seed)``, key order), so
    that no ReLU map is half zeros."""
    flat = flatten_variables(numpy_init(model, 0))
    rng = np.random.RandomState(seed)
    for k in sorted(flat):
        if k.endswith("/bias_bn"):
            flat[k] = rng.normal(0.5, 0.5, flat[k].shape).astype(np.float32)
        elif k.endswith("/bias") and k.startswith("params/"):
            flat[k] = rng.normal(0.1, 0.2, flat[k].shape).astype(np.float32)
    return unflatten_variables(flat)


def calibrated(jmodel, tree, size, batch=2, seed=0):
    """JAX variables after two QAT forwards in train mode (BN statistics
    and observers move) on ``RandomState(seed)`` images."""
    v = jax_variables(tree)
    rng = np.random.RandomState(seed)
    step = jax.jit(lambda vv, xb: jmodel.apply(vv, xb, mode=jnn.QAT, train=True,
                                               mutable=["batch_stats", "quant"],
                                               rngs={"dropout": jax.random.PRNGKey(0)}))
    for _ in range(2):
        _, upd = step(v, jnp.asarray(rng.randn(batch, size, size, 3).astype(np.float32)))
        v = {**v, **upd}
    return unflatten_variables(flatten_variables(jax.tree.map(np.asarray, v)))


def jax_module_codes(model, variables, images):
    """(output, {module path: codes}) of the frozen JAX graph: the QTensor
    output of every module call, recorded inside the one jit."""
    import flax.linen as fnn

    def fn(x):
        codes = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.method_name == "__call__" and isinstance(out, JQTensor):
                codes["/".join(context.module.scope.path)] = out.q
            return out

        with fnn.intercept_methods(record):
            out = model.apply(variables, x, mode=jnn.INT8)
        return out, codes

    out, codes = jax.jit(fn)(jnp.asarray(images))
    return np.asarray(out), {k: np.asarray(v) for k, v in codes.items()}


def port_module_codes(model, fn, images):
    """(output, {module path: codes}) of one call of the port's frozen graph."""
    codes, hooks = {}, []
    for name, mod in model.named_modules():
        if name:
            def hook(m, args, out, key="/".join(name.split("."))):
                if isinstance(out, QTensor):
                    codes[key] = out.q.cpu().numpy()
            hooks.append(mod.register_forward_hook(hook))
    try:
        out = fn(images)
    finally:
        for h in hooks:
            h.remove()
    return out.cpu().numpy(), codes


def assert_codes_equal(jcodes, codes, min_distinct=8):
    assert sorted(codes) == sorted(jcodes)
    for k, want in jcodes.items():
        np.testing.assert_array_equal(codes[k], want, err_msg=k)
    varied = sum(len(np.unique(c)) >= min_distinct for c in jcodes.values())
    assert varied >= 0.8 * len(jcodes), (varied, len(jcodes))


@pytest.mark.parametrize("case", INT8_CASES, ids=lambda c: f"{c[0]}-{c[2]}")
def test_int8_codes_bit_equal(case):
    name, size, backend = case
    jm = jax_create_model(name, num_classes=CLASSES, qconfig=jq.get_qconfig(backend))
    tm = create_model(name, num_classes=CLASSES, qconfig=get_qconfig(backend), image_size=size)
    tree = calibrated(jm, shifted_tree(tm), size)
    images = np.random.RandomState(5).randn(2, size, size, 3).astype(np.float32)
    jout, jcodes = jax_module_codes(jm, jax_variables(tree), images)
    from_jax_variables(tm, tree)
    out, codes = port_module_codes(tm, freeze(tm, "cpu", size), images)
    assert_codes_equal(jcodes, codes)
    np.testing.assert_array_equal(out, jout)
    routes = {m._route for m in tm.modules() if isinstance(m, tnn.QConvBNAct)}
    want = {"qshufflenet_v2_x0_5": {"im2col", "matmul", "depthwise"},
            "qvgg11_bn": {"dense3x3"}, "qalexnet": {"im2col", "dense3x3"},
            "cifar_alexnet": {"im2col", "dense3x3"}}[name]
    assert routes == want
    if name in ("qvgg11_bn", "cifar_alexnet"):  # the first conv, a 3x3 of 3 channels
        assert any(m._route == "dense3x3" and m.in_features == 3 for m in tm.modules()
                   if isinstance(m, tnn.QConvBNAct))


# ---------------------------------------------------------------------------
# Training against the jitted JAX steps
# ---------------------------------------------------------------------------

# (name, size, batch): ShuffleNetV2 at batch 8 (at batch 4 its last BN sees 4
# values a channel and the FP32 loss moved by 1.5e-5); CifarAlexNet at 16x16,
# where its head is 2304 wide (at 32x32, 12544: 68 M weights a step)
TRAIN_CASES = [("qshufflenet_v2_x0_5", 32, 8), ("qvgg11_bn", 32, 4), ("qalexnet", 64, 4),
               ("cifar_alexnet", 16, 4)]


def train_both(name, size, batch):
    """FP32 step, start_qat, QAT step, QAT_FROZEN eval step in both packages
    from one ``numpy_init`` tree (lr 1e-3, QSGD, no dropout)."""
    kw = {} if "shufflenet" in name else {"drop_rate": 0.0}  # ShuffleNetV2 has no dropout
    tm = create_model(name, num_classes=CLASSES, image_size=size, **kw)
    jm = jax_create_model(name, num_classes=CLASSES, **kw)
    tree = {"batch_stats": {}, **numpy_init(tm, 0)}  # AlexNet has no BN
    batches = [train_batch(k, batch, size, CLASSES) for k in range(3)]
    tx = jax_optimizer("QSGD", 1e-3, weight_decay=jax_gwd(4e-5), noise_decay=1.0)
    js = jax_train_state(jm, tree, tx)
    jmetrics = []
    for k, mode in enumerate((jnn.FP32, jnn.QAT)):
        if k == 1:
            js = js.start_qat()
        js, m = jax_train_step(jm, mode, num_classes=CLASSES, donate=False)(js, batches[k])
        jmetrics.append(jax.tree.map(float, m))
    jmetrics.append(jax.tree.map(float, jax_eval_step(jm, jnn.QAT_FROZEN, CLASSES)(js,
                                                                                    batches[2])))
    tx = get_optimizer("QSGD", 1e-3, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(tm, tx, seed=0, device="cpu", variables=tree)
    metrics = []
    for k, mode in enumerate((tnn.FP32, tnn.QAT)):
        if k == 1:
            state.start_qat()
        m = make_train_step(mode, num_classes=CLASSES)(state, batches[k])
        metrics.append({n: float(v) for n, v in m.items()})
    metrics.append({n: float(v) for n, v in
                    make_eval_step(tnn.QAT_FROZEN, CLASSES)(state, batches[2]).items()})
    return metrics, jmetrics


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: c[0])
def test_train_steps_within_bands(case):
    (fp32, qat, ev), (jfp32, jqat, jev) = train_both(*case)
    assert abs(fp32["loss"] - jfp32["loss"]) <= FP32_LOSS_REL * jfp32["loss"], (fp32, jfp32)
    for got, want in ((qat, jqat), (ev, jev)):
        assert np.isfinite(got["loss"])
        assert abs(got["loss"] - want["loss"]) <= QAT_LOSS_REL * want["loss"], (got, want)


# ---------------------------------------------------------------------------
# The float-only baselines
# ---------------------------------------------------------------------------

# (name, JAX model, port model, size, update band): small configurations of
# each family, at sizes where the last train-mode BN sees 16 or more values a
# channel (batch 4 on 2x2 or larger maps; on 1x1 maps the float sums' order
# moved the loss by up to 8e-5, MNASNet 0.5 at 32x32 and Inception-v3 at
# 75x75). Inception-v3's backward through ~45 train-mode BNs at init is
# ill-conditioned (stem gradients ~400): the port against itself on 1 and 4
# CPU threads moves its update by 2.7-4.6% (JAX's by 2.5-5.0%), so its update
# band is INCEPTION_UPDATE_REL; its loss still agrees to 6.5e-6.
INCEPTION_UPDATE_REL = 0.1
FP_CASES = [
    ("densenet", lambda: jfp.DenseNet(growth_rate=8, block_config=(2, 2), num_init_features=16,
                                      num_classes=CLASSES),
     lambda: fp_only.DenseNet(growth_rate=8, block_config=(2, 2), num_init_features=16,
                              num_classes=CLASSES), 32, UPDATE_REL),
    ("squeezenet1_1", lambda: jfp.SqueezeNet(version="1_1", num_classes=CLASSES, drop_rate=0.0),
     lambda: fp_only.SqueezeNet(version="1_1", num_classes=CLASSES), 64, UPDATE_REL),
    ("mnasnet0_5", lambda: jfp.MNASNet(alpha=0.5, num_classes=CLASSES, drop_rate=0.0),
     lambda: fp_only.MNASNet(alpha=0.5, num_classes=CLASSES), 64, UPDATE_REL),
    ("inception_v3", lambda: jfp.InceptionV3(num_classes=CLASSES, drop_rate=0.0),
     lambda: fp_only.InceptionV3(num_classes=CLASSES), 139, INCEPTION_UPDATE_REL),
]


def _fp_apply(jm, v, x, train):
    return jm.apply(v, x, train=train, mutable=["batch_stats"] if train else False,
                    rngs={"dropout": jax.random.PRNGKey(0)})


@pytest.mark.parametrize("case", FP_CASES, ids=lambda c: c[0])
def test_float_only_forward_and_train_step(case):
    """The eval forward within ``FLOAT_REL`` of its largest logit; one SGD
    step on a batch (dropout off in both packages): the loss within
    ``FP32_LOSS_REL``, the update within ``UPDATE_REL`` (Inception-v3:
    ``INCEPTION_UPDATE_REL``), the BN statistics within 1e-4 of JAX's
    (relative to their std)."""
    import optax

    name, jmake, tmake, size, update_rel = case
    jm, tm = jmake(), tmake()
    tm.drop_rate = 0.0  # as the JAX model built with drop_rate=0.0
    tree = numpy_init(tm, 3)
    x = np.random.RandomState(5).randn(4, size, size, 3).astype(np.float32)
    v = jax_variables(tree)
    jy = np.asarray(jax.jit(lambda vv, xx: _fp_apply(jm, vv, xx, False))(v, jnp.asarray(x)))
    from_jax_variables(tm, tree)
    with torch.no_grad():
        ty = tm(torch.as_tensor(x), mode=tnn.FP32).numpy()
    assert np.abs(ty - jy).max() <= FLOAT_REL * np.abs(jy).max(), np.abs(ty - jy).max()

    labels = np.arange(4) % CLASSES

    def jloss(params, stats):
        logits, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(0)})
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), upd

    (jl, upd), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"], v.get("batch_stats", {}))
    jparams = jax.tree.map(lambda p, g: p - 0.01 * g, v["params"], grads)
    tm.train()
    logits = tm(torch.as_tensor(x), mode=tnn.FP32, train=True)
    loss = torch.nn.functional.cross_entropy(logits, torch.as_tensor(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= FP32_LOSS_REL * abs(float(jl))
    with torch.no_grad():
        for p in tm.parameters():
            p -= 0.01 * p.grad
    jflat = flatten_variables({"params": jax.tree.map(np.asarray, jparams),
                               "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    init, mine = flatten_variables(tree), {k: t.detach().numpy()
                                           for k, t in model_variables(tm).items()}
    params = [k for k in init if k.startswith("params/")]
    d_jax = np.concatenate([(jflat[k] - init[k]).ravel() for k in params])
    d_port = np.concatenate([(mine[k] - init[k]).ravel() for k in params])
    assert np.linalg.norm(d_port - d_jax) <= update_rel * np.linalg.norm(d_jax)
    for k in jflat:
        if k.endswith("/mean"):
            std = np.sqrt(jflat[k[:-len("mean")] + "var"])
            assert np.max(np.abs(mine[k] - jflat[k]) / std) <= 1e-4, k


def test_float_only_refuses_quantized_modes():
    """The JAX models take no ``mode`` (``__call__(x, train)``), so JAX's
    train and eval steps raise ``TypeError`` on them in every phase; the
    port runs FP32 (its trainer's warm-up) and raises ``TypeError`` in QAT,
    QAT_FROZEN and INT8 and on ``prepare_int8``."""
    jm = jfp.SqueezeNet(version="1_1", num_classes=CLASSES)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    for mode in (jnn.FP32, jnn.QAT, jnn.INT8):
        with pytest.raises(TypeError, match="mode"):
            jm.apply(v, x, mode=mode)
    for name in ("densenet121", "squeezenet1_1", "mnasnet0_5", "inception_v3"):
        tm = create_model(name, num_classes=CLASSES)
        assert not any(k.startswith("quant/") for k in model_variables(tm))
        for mode in (tnn.QAT, tnn.QAT_FROZEN, tnn.INT8):
            with pytest.raises(TypeError, match="float-only"):
                tm(torch.zeros(1, 75, 75, 3), mode=mode)
        with pytest.raises(TypeError, match="float-only"):
            freeze(tm, "cpu", 75)


# ---------------------------------------------------------------------------
# The ESPNetv2 classifier
# ---------------------------------------------------------------------------

def test_espnetv2_classifier_has_no_int8_forward():
    jm = jax_create_model("espnetv2_s_0_5", num_classes=CLASSES)
    tm = create_model("espnetv2_s_0_5", num_classes=CLASSES)
    tree = calibrated(jm, numpy_init(tm, 0), 32)
    with pytest.raises(AssertionError, match="INT8 mode needs a QTensor input"):
        jax.jit(lambda vv, xx: jm.apply(vv, xx, mode=jnn.INT8))(
            jax_variables(tree), jnp.zeros((1, 32, 32, 3), jnp.float32))
    from_jax_variables(tm, tree)
    for call in (lambda: freeze(tm, "cpu", 32),
                 lambda: tm(torch.zeros(1, 32, 32, 3), mode=tnn.INT8)):
        with pytest.raises(NotImplementedError, match="espnet.py:138") as err:
            call()
        assert "nn/conv.py:374" in str(err.value) and err.value.args[0] == CLASSIFIER_INT8


@pytest.mark.parametrize("phase", ["FP32", "QAT"])
def test_espnetv2_classifier_dummy_reinforcement(phase):
    """``level5_0`` runs its reinforcement on a (1, 1, 1, 3) zeros image in
    every forward: in train mode its BN statistics step toward that one
    value a channel (variance 0; torch's ``batch_norm`` refuses it), in QAT
    its observers see it. After one train forward (``drop_rate`` 0, 64x64,
    batch 4) both packages hold the same statistics there (the running
    variances exactly 0.9 of 1 at ``inp_reinf0``, the means within 1e-4 of a
    std), the same observers (within 1% of their range: a weight code on a
    rounding boundary may move, Queue C), and logits within
    ``FP32_LOSS_REL`` (FP32) or ``QAT_LOSS_REL`` (QAT) of their largest."""
    jmode, tmode = {"FP32": (jnn.FP32, tnn.FP32), "QAT": (jnn.QAT, tnn.QAT)}[phase]
    jm = jax_create_model("espnetv2_s_0_5", num_classes=CLASSES, drop_rate=0.0)
    tm = create_model("espnetv2_s_0_5", num_classes=CLASSES, drop_rate=0.0)
    tree = shifted_tree(tm)
    x = np.random.RandomState(2).randn(4, 64, 64, 3).astype(np.float32)
    jy, upd = jax.jit(lambda vv, xx: jm.apply(vv, xx, mode=jmode, train=True,
                                              mutable=["batch_stats", "quant"]))(
        jax_variables(tree), jnp.asarray(x))
    from_jax_variables(tm, tree)
    ty = tm(torch.as_tensor(x), mode=tmode, train=True).detach().numpy()
    jflat = flatten_variables(jax.tree.map(np.asarray, {**jax_variables(tree), **upd}))
    mine = {k: v.detach().numpy() for k, v in model_variables(tm).items()}
    keys = [k for k in jflat if "level5_0/inp_reinf" in k and not k.startswith("params/")]
    assert len(keys) == 12  # two convs: BN mean and var, weight and output observers
    for k in keys:
        if k.endswith("/var"):
            np.testing.assert_allclose(mine[k], jflat[k], rtol=1e-6, err_msg=k)
        elif k.endswith("/mean"):
            std = np.sqrt(jflat[k[:-len("mean")] + "var"])
            assert np.max(np.abs(mine[k] - jflat[k]) / std) <= 1e-4, k
        elif k.endswith(".min_val") and phase == "QAT":
            hi = k.replace(".min_val", ".max_val")
            span = float(np.max(jflat[hi] - jflat[k]))
            assert max(np.max(np.abs(mine[k] - jflat[k])),
                       np.max(np.abs(mine[hi] - jflat[hi]))) <= 0.01 * span, k
        elif phase == "FP32":  # observers untouched in FP32
            np.testing.assert_array_equal(mine[k], jflat[k], err_msg=k)
    # the zeros image gives inp_reinf0 a batch mean of 0 and a variance of 0:
    # its running variance steps from 1 toward 0, inp_reinf1's mean moves
    assert mine["batch_stats/level5_0/inp_reinf0/var"] == pytest.approx([0.9] * 3)
    assert (mine["batch_stats/level5_0/inp_reinf1/mean"] != 0).any()
    jy = np.asarray(jy)
    band = FP32_LOSS_REL if phase == "FP32" else QAT_LOSS_REL
    assert np.abs(ty - jy).max() <= band * np.abs(jy).max(), np.abs(ty - jy).max()
