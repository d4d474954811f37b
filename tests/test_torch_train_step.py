"""PyTorch port, the training path of a whole model, against the JAX package.

``frostnet_quant_small_0_35`` at 32x32, batch 8, ``drop_rate`` 0, both
packages from the same ``numpy_init`` variables and the same uint8
batches: one FP32 (StatAssist) step, ``start_qat``, one QAT step with
QSGD (lr 0.04, ``grouped_weight_decay(4e-5)``; the GradBoost noise off
with ``noise_decay=1.0``, its draws cannot match), then a QAT_FROZEN eval
step. The float parts (convolutions, BN in train mode, the loss) are held
to bands stated below; the observers and BN statistics must step exactly
once per train step and not at all in FP32 (observers) or eval. The
trained port model then freezes, and its INT8 logits equal those of JAX's
``freeze`` on the same variables bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_train_state, jax_variables, train_batch
from frostnet_tpu.models import create_model as jax_create_model
from frostnet_tpu.nn import FP32 as JFP32, QAT as JQAT, QAT_FROZEN as JQAT_FROZEN
from frostnet_tpu.optim import get_optimizer as jax_optimizer
from frostnet_tpu.optim import grouped_weight_decay as jax_gwd
from frostnet_tpu.quant import freeze as jax_freeze
from frostnet_tpu.train.state import make_eval_step as jax_eval_step
from frostnet_tpu.train.state import make_train_step as jax_train_step
from frostnet_tpu_torch import ops
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.nn import FP32, QAT, QAT_FROZEN
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import freeze, model_variables, numpy_init
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
from frostnet_tpu_torch.train import (create_train_state, make_eval_step, make_train_step,
                                      prep_image, recalibrate)

MODEL, SIZE, BATCH, CLASSES = "frostnet_quant_small_0_35", 32, 8, 10
# Bands. FP32: the float32 convolutions and BN reductions sum in other
# orders, relative ~1e-6 (measured here: loss 1e-6, BN statistics 2e-5).
FP32_LOSS_REL = 1e-5
FP32_STAT = 1e-4          # |d mean| / std and |d var| / var after the FP32 step
# QAT: fed the same input, each layer agrees to ~1e-6 except where a value
# sits on a rounding boundary and its code moves by one quantum. When that
# value is a tensor's observed extreme, the tensor's whole grid moves, and
# the next layers carry it. At 32x32 the last stage's maps are 1x1, so its
# BN normalizes over 8 values a channel, and at random init the logits are
# ~30: measured here, the QAT step's loss 26% apart, the eval step's 14%,
# observers 0.35% of their range in the median and 36% at worst (the
# classifier's output), BN means 0.4% of a std in the median. (At 224x224
# the same comparison gives 0.9% and 0.03%: chip_smoke.py phase 8.)
QAT_LOSS_REL = 0.5
QAT_OBS_MEDIAN, QAT_OBS_WORST = 0.01, 0.6   # of the observed range
QAT_BN_MEDIAN = 0.02                         # |d mean| / std


def _port_state():
    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    return create_train_state(model, tx, seed=0, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """Both packages through FP32 step, start_qat, QAT step, eval step."""
    tree = numpy_init(create_model(MODEL, num_classes=CLASSES), 0)
    batches = [train_batch(k, BATCH, SIZE, CLASSES) for k in range(3)]

    jmodel = jax_create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    tx = jax_optimizer("QSGD", 0.04, weight_decay=jax_gwd(4e-5), noise_decay=1.0)
    js = jax_train_state(jmodel, tree, tx)
    jax_states, jax_metrics = [js], []
    for k, mode in enumerate((JFP32, JQAT)):
        if k == 1:
            js = js.start_qat()
        js, m = jax_train_step(jmodel, mode, num_classes=CLASSES, donate=False)(js, batches[k])
        jax_states.append(js)
        jax_metrics.append(jax.tree.map(float, m))
    jax_metrics.append(jax.tree.map(float, jax_eval_step(jmodel, JQAT_FROZEN, CLASSES)(
        js, batches[2])))

    state = _port_state()
    flats, metrics = [flatten_variables(tree)], []
    for k, mode in enumerate((FP32, QAT)):
        if k == 1:
            state.start_qat()
        m = make_train_step(mode, num_classes=CLASSES)(state, batches[k])
        metrics.append({n: float(v) for n, v in m.items()})
        flats.append({n: v.detach().numpy().copy() for n, v in
                      model_variables(state.model).items()})
    before_eval = {n: v.detach().clone() for n, v in model_variables(state.model).items()}
    m = make_eval_step(QAT_FROZEN, CLASSES)(state, batches[2])
    metrics.append({n: float(v) for n, v in m.items()})
    jax_flats = [flatten_variables(jax.tree.map(np.asarray, s.model_variables))
                 for s in jax_states]
    return dict(state=state, jmodel=jmodel, flats=flats, jax_flats=jax_flats,
                metrics=metrics, jax_metrics=jax_metrics, before_eval=before_eval,
                batches=batches)


def _bn_errors(flat, jflat):
    """(|d mean| / std, |d var| / var) per BN, against JAX's statistics."""
    out = []
    for k in jflat:
        if k.endswith("/mean"):
            v = k[:-len("mean")] + "var"
            out.append((float(np.max(np.abs(flat[k] - jflat[k]) / np.sqrt(jflat[v]))),
                        float(np.max(np.abs(flat[v] - jflat[v]) / jflat[v]))))
    return np.asarray(out)


def test_losses_and_top1_within_band(runs):
    (fp32, qat, ev), (jfp32, jqat, jev) = runs["metrics"], runs["jax_metrics"]
    assert abs(fp32["loss"] - jfp32["loss"]) <= FP32_LOSS_REL * jfp32["loss"], (fp32, jfp32)
    assert fp32["top1"] == jfp32["top1"] and fp32["top5"] == jfp32["top5"]
    for got, want in ((qat, jqat), (ev, jev)):
        assert abs(got["loss"] - want["loss"]) <= QAT_LOSS_REL * want["loss"], (got, want)
        assert np.isfinite(got["loss"]) and 0 <= got["top1"] <= got["top5"] <= 1


def test_observers_and_bn_within_band(runs):
    init, after_fp32, after_qat = runs["flats"]
    _, jfp32, jqat = runs["jax_flats"]
    obs = [k for k in init if k.startswith("quant/")]
    # FP32 observes nothing; QAT snaps every fresh observer to its batch
    for k in obs:
        np.testing.assert_array_equal(after_fp32[k], init[k])
        assert np.isfinite(after_qat[k]).all(), k
    rel = []
    for k in obs:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            rng = float(jqat[hi] - jqat[k])
            rel.append(max(abs(float(after_qat[k] - jqat[k])),
                           abs(float(after_qat[hi] - jqat[hi]))) / max(rng, 1e-6))
    assert np.median(rel) <= QAT_OBS_MEDIAN and max(rel) <= QAT_OBS_WORST, rel
    assert _bn_errors(after_fp32, jfp32).max() <= FP32_STAT
    assert np.median(_bn_errors(after_qat, jqat)[:, 0]) <= QAT_BN_MEDIAN
    for k in init:
        if k.startswith("batch_stats/"):
            assert not np.array_equal(after_fp32[k], init[k]), k


@pytest.mark.parametrize("mode", ["FP32", "QAT"])
def test_train_step_advances_observers_and_bn_exactly_once(mode):
    """A train step leaves the observers and BN statistics where one
    forward in train mode from the same state leaves them: the backward and
    the optimizer step add no update."""
    tmode = {"FP32": FP32, "QAT": QAT}[mode]
    batch = train_batch(0, BATCH, SIZE, CLASSES)
    state = _port_state()
    if mode == "QAT":  # calibrated observers take the moving-average branch
        recalibrate(state, [train_batch(5, BATCH, SIZE, CLASSES)], mode=QAT)
    ref = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    ref.load_state_dict(state.model.state_dict())
    with torch.no_grad():
        ref(prep_image(torch.as_tensor(batch["image"])), mode=tmode, train=True)
    make_train_step(tmode, num_classes=CLASSES)(state, batch)
    mine = model_variables(state.model)
    for k, v in model_variables(ref).items():
        if not k.startswith("params/"):
            assert torch.equal(mine[k], v), k


def test_eval_step_changes_nothing(runs):
    after = model_variables(runs["state"].model)
    for k, v in runs["before_eval"].items():
        assert torch.equal(after[k], v), k


def test_trained_model_freezes_bit_exact_to_jax(runs):
    """Freezing the trained port model and serving it (plain versions on the
    CPU) gives the logits of JAX's freeze on the same variables."""
    state = runs["state"]
    tree = unflatten_variables({k: v.detach().numpy().copy()
                                for k, v in model_variables(state.model).items()})
    images = np.random.RandomState(4).randn(4, SIZE, SIZE, 3).astype(np.float32)
    want = np.asarray(jax_freeze(runs["jmodel"], jax_variables(tree))(jnp.asarray(images)))
    ops.reset_launch_counts()
    for fuse in (False, True):
        port = create_model(MODEL, num_classes=CLASSES, fuse_int8=fuse)
        port.load_state_dict(state.model.state_dict())
        got = freeze(port, device="cpu", image_size=SIZE)(images)
        np.testing.assert_array_equal(got.numpy(), want)
    assert set(ops.launch_counts().values()) == {0}


def test_recalibrate_steps_observers_and_bn_only():
    state = _port_state()
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    recalibrate(state, [train_batch(0, 4, SIZE, CLASSES)], mode=QAT)
    for n, p in state.model.named_parameters():
        assert torch.equal(p, params[n]), n
    assert torch.isfinite(state.model.quant.act.min_val)
    assert not torch.equal(state.model.conv1.mean, torch.zeros_like(state.model.conv1.mean))


@pytest.mark.parametrize("weights,ignore,smoothing", [(False, None, 0.0), (True, 3, 0.0),
                                                      (False, None, 0.1), (True, 255, 0.2)])
def test_cross_entropy_and_topk_match_jax(weights, ignore, smoothing):
    """The loss against ``frostnet_tpu.utils.losses.cross_entropy`` (jitted,
    runtime logits), within float32 rounding (log-softmax is computed by each
    framework's own exp/log); top-k exactly."""
    from frostnet_tpu.utils.losses import cross_entropy as jax_ce
    from frostnet_tpu.utils.metrics import topk_accuracy as jax_topk
    from frostnet_tpu_torch.utils import cross_entropy, topk_accuracy

    rng = np.random.RandomState(7)
    logits = (rng.randn(64, 10) * 3).astype(np.float32)
    labels = rng.randint(0, 10, 64).astype(np.int32)
    labels[:4] = [3, 255, -1, 12]  # the ignore label and out-of-range labels
    w = (rng.rand(10) + 0.5).astype(np.float32) if weights else None
    want = float(jax.jit(lambda lg, lb: jax_ce(
        lg, lb, None if w is None else jnp.asarray(w), ignore, smoothing))(logits, labels))
    got = float(cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                              None if w is None else torch.as_tensor(w), ignore, smoothing))
    assert abs(got - want) <= 1e-6 * abs(want)
    jt = jax.jit(lambda lg, lb: jax_topk(lg, lb, (1, 5)))(logits, labels)
    tt = topk_accuracy(torch.as_tensor(logits), torch.as_tensor(labels), (1, 5))
    assert [float(v) for v in tt] == [float(v) for v in jt]


def test_prep_image_matches_jax():
    """uint8 normalization on the device equals the jitted JAX step's bit for bit."""
    from frostnet_tpu.train.state import _prep_image

    img = np.random.RandomState(0).randint(0, 256, (4, 8, 8, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(_prep_image)(img))
    np.testing.assert_array_equal(prep_image(torch.as_tensor(img)).numpy(), want)
    x = torch.randn(2, 4, 4, 3)
    assert prep_image(x) is x


def test_ema_and_eval_on_ema_parameters():
    """The parameter EMA steps as ``decay * e + (1 - decay) * p``, and the
    eval step on it leaves the trained parameters in place."""
    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    state = create_train_state(model, get_optimizer("SGD", 1e-3), device="cpu", ema_decay=0.5)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = train_batch(0, 4, SIZE, CLASSES)
    make_train_step(FP32, num_classes=CLASSES, ema_decay=0.5)(state, batch)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n in after:
        torch.testing.assert_close(state.ema[n], 0.5 * before[n] + 0.5 * after[n],
                                   rtol=0, atol=1e-7)
    on_ema = make_eval_step(FP32, CLASSES, use_ema=True)(state, batch)
    for n, p in model.named_parameters():
        assert torch.equal(p, after[n]), n
    reference = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    reference.load_state_dict(model.state_dict())
    with torch.no_grad():
        for n, p in reference.named_parameters():
            p.copy_(state.ema[n])
        logits = reference(prep_image(torch.as_tensor(batch["image"])), mode=FP32)
    from frostnet_tpu_torch.utils import cross_entropy
    assert float(on_ema["loss"]) == float(cross_entropy(logits, torch.as_tensor(batch["label"])))
