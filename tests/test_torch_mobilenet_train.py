"""PyTorch port, MobileNet and float FrostNet training against the JAX package.

* ``qmobilenet_v3_small_HS`` (width 0.5, 32x32, batch 8, ``drop_rate`` 0):
  both packages from the same ``numpy_init`` variables and uint8 batches,
  one FP32 step, ``start_qat``, one QAT step (QSGD lr 1e-3, QAT at random
  init being chaotic between the packages; ``grouped_weight_decay(4e-5)``,
  the GradBoost noise off) and a QAT_FROZEN eval step, within the bands of
  ``tests/test_torch_train_step.py``; the trained port model freezes bit
  for bit to JAX's ``freeze`` of the same variables.
* The float models (``frostnet_small_0_35``, ``mobilenet_v3_small_HS``,
  ``mobilenet_v2_ReLU6``): the FP32 eval forward within ``FLOAT_REL``; the
  loss of one SGD step (BN in train mode) within ``TRAIN_LOSS_REL`` and its
  update within ``UPDATE_REL``. At 32x32 the last maps are 1x1, so BN in
  train mode normalizes over 4 values a channel: the packages' summation
  orders move the train-mode loss by 2.2e-5 and 2.4e-5 relative (the two
  larger models, measured here) and the gradients, which reach ~1e3, by
  ~2e-3 relative.
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
from frostnet_tpu.optim import get_optimizer as jax_optimizer
from frostnet_tpu.optim import grouped_weight_decay as jax_gwd
from frostnet_tpu.train.state import make_eval_step as jax_eval_step
from frostnet_tpu.train.state import make_train_step as jax_train_step
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.nn import FP32, INT8, QAT, QAT_FROZEN
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import freeze, from_jax_variables, model_variables, numpy_init
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
from frostnet_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from test_torch_train_step import FP32_LOSS_REL, QAT_LOSS_REL

pytestmark = pytest.mark.usefixtures("few_threads")
CLASSES = 10
FLOAT_REL = 1e-5
TRAIN_LOSS_REL = 1e-4
UPDATE_REL = 1e-2  # |d update| / |update|, over all parameters


# ---------------------------------------------------------------------------
# Training against the jitted JAX steps
# ---------------------------------------------------------------------------

TRAIN_MODEL, TRAIN_WIDTH, TRAIN_SIZE, TRAIN_BATCH = "qmobilenet_v3_small_HS", 0.5, 32, 8


@pytest.fixture(scope="module")
def train_runs():
    tree = numpy_init(create_model(TRAIN_MODEL, num_classes=CLASSES, width_mult=TRAIN_WIDTH), 0)
    batches = [train_batch(k, TRAIN_BATCH, TRAIN_SIZE, CLASSES) for k in range(3)]
    jmodel = jax_create_model(TRAIN_MODEL, num_classes=CLASSES, width_mult=TRAIN_WIDTH,
                              drop_rate=0.0)
    tx = jax_optimizer("QSGD", 1e-3, weight_decay=jax_gwd(4e-5), noise_decay=1.0)
    js = jax_train_state(jmodel, tree, tx)
    jmetrics, jflats = [], []
    for k, mode in enumerate((jnn.FP32, jnn.QAT)):
        if k == 1:
            js = js.start_qat()
        js, m = jax_train_step(jmodel, mode, num_classes=CLASSES, donate=False)(js, batches[k])
        jmetrics.append(jax.tree.map(float, m))
        jflats.append(flatten_variables(jax.tree.map(np.asarray, js.model_variables)))
    jmetrics.append(jax.tree.map(float, jax_eval_step(jmodel, jnn.QAT_FROZEN, CLASSES)(
        js, batches[2])))

    model = create_model(TRAIN_MODEL, num_classes=CLASSES, width_mult=TRAIN_WIDTH, drop_rate=0.0)
    tx = get_optimizer("QSGD", 1e-3, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(model, tx, seed=0, device="cpu")
    metrics, flats = [], []
    for k, mode in enumerate((FP32, QAT)):
        if k == 1:
            state.start_qat()
        m = make_train_step(mode, num_classes=CLASSES)(state, batches[k])
        metrics.append({n: float(v) for n, v in m.items()})
        flats.append({n: v.detach().numpy().copy() for n, v in
                      model_variables(state.model).items()})
    metrics.append({n: float(v) for n, v in
                    make_eval_step(QAT_FROZEN, CLASSES)(state, batches[2]).items()})
    return dict(metrics=metrics, jax_metrics=jmetrics, flats=flats, jax_flats=jflats,
                state=state, jmodel=jmodel)


def test_train_losses_within_bands(train_runs):
    (fp32, qat, ev), (jfp32, jqat, jev) = train_runs["metrics"], train_runs["jax_metrics"]
    assert abs(fp32["loss"] - jfp32["loss"]) <= FP32_LOSS_REL * jfp32["loss"], (fp32, jfp32)
    assert fp32["top1"] == jfp32["top1"]
    for got, want in ((qat, jqat), (ev, jev)):
        assert abs(got["loss"] - want["loss"]) <= QAT_LOSS_REL * want["loss"], (got, want)


def test_train_observers_and_bn_within_bands(train_runs):
    """Every observer (new sites: the SE's dense weights and activations, the
    hard-swish's ReLU6 and mul) steps once in the QAT step and not in the
    FP32 one; the QAT observers within 3% of their range in the median
    (the port's FP32 BN statistics within 1e-4 of a std)."""
    (after_fp32, after_qat), (jfp32, jqat) = train_runs["flats"], train_runs["jax_flats"]
    obs = [k for k in after_qat if k.startswith("quant/") and k.endswith(".min_val")]
    assert any("/se/fc1/w_obs" in k for k in obs) and any("relu6_obs" in k for k in obs)
    rel = []
    for k in obs:
        hi = k.replace(".min_val", ".max_val")
        assert np.isinf(after_fp32[k]).all(), k
        span = float(np.max(jqat[hi] - jqat[k]))
        rel.append(float(np.max(np.maximum(np.abs(after_qat[k] - jqat[k]),
                                            np.abs(after_qat[hi] - jqat[hi])))) / max(span, 1e-6))
    assert np.median(rel) <= 0.03, np.median(rel)
    for k in jfp32:
        if k.endswith("/mean"):
            var = k[:-len("mean")] + "var"
            assert np.max(np.abs(after_fp32[k] - jfp32[k]) / np.sqrt(jfp32[var])) <= 1e-4, k


def test_trained_mobilenet_freezes_bit_exact_to_jax(train_runs):
    state = train_runs["state"]
    tree = unflatten_variables({k: v.detach().numpy().copy()
                                for k, v in model_variables(state.model).items()})
    images = np.random.RandomState(4).randn(4, TRAIN_SIZE, TRAIN_SIZE, 3).astype(np.float32)
    want = np.asarray(jq.freeze(train_runs["jmodel"], jax_variables(tree))(jnp.asarray(images)))
    port = create_model(TRAIN_MODEL, num_classes=CLASSES, width_mult=TRAIN_WIDTH)
    port.load_state_dict(state.model.state_dict())
    np.testing.assert_array_equal(freeze(port, "cpu", TRAIN_SIZE)(images).numpy(), want)


@pytest.mark.parametrize("name,width", [("frostnet_small_0_35", None),
                                        ("mobilenet_v3_small_HS", 0.5),
                                        ("mobilenet_v2_ReLU6", 0.35)])
def test_float_models_forward_and_train_step(name, width):
    """The float models (no observers, no QAdd/QCat/QMul; a float residual
    and concatenate) in FP32: the eval forward, then one SGD train step."""
    kw = {} if width is None else {"width_mult": width}
    tree = numpy_init(create_model(name, num_classes=CLASSES, **kw), 1)
    x = np.random.RandomState(5).randn(4, 32, 32, 3).astype(np.float32)
    jmodel = jax_create_model(name, num_classes=CLASSES, drop_rate=0.0, **kw)
    jy = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, mode=jnn.FP32))(
        jax_variables(tree), jnp.asarray(x)))
    port = create_model(name, num_classes=CLASSES, drop_rate=0.0, **kw)
    from_jax_variables(port, tree)
    with torch.no_grad():
        ty = port(torch.as_tensor(x), mode=FP32).numpy()
    assert np.abs(ty - jy).max() <= FLOAT_REL * np.abs(jy).max()

    batch = train_batch(0, 4, 32, CLASSES)
    tx = jax_optimizer("SGD", 1e-2)
    js, jm = jax_train_step(jmodel, jnn.FP32, num_classes=CLASSES, donate=False)(
        jax_train_state(jmodel, tree, tx), batch)
    state = create_train_state(create_model(name, num_classes=CLASSES, drop_rate=0.0, **kw),
                               get_optimizer("SGD", 1e-2), device="cpu", variables=tree)
    m = make_train_step(FP32, num_classes=CLASSES)(state, batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TRAIN_LOSS_REL * abs(float(jm["loss"]))
    jflat = flatten_variables(jax.tree.map(np.asarray, js.model_variables))
    init = flatten_variables(tree)
    mine = {k: v.detach().numpy() for k, v in model_variables(state.model).items()}
    params = [k for k in init if k.startswith("params/")]
    d_jax = np.concatenate([(jflat[k] - init[k]).ravel() for k in params])
    d_port = np.concatenate([(mine[k] - init[k]).ravel() for k in params])
    assert np.linalg.norm(d_port - d_jax) <= UPDATE_REL * np.linalg.norm(d_jax)
    # INT8 mode of a float model runs float, as JAX's does
    port.prepare_int8("cpu", 32)
    with torch.no_grad():
        np.testing.assert_array_equal(port(torch.as_tensor(x), mode=INT8).numpy(), ty)
