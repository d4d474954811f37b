"""The committed full-width detection fixtures of the PyTorch port.

For ``qssd`` (SSDLite-MobileNetV2) and ``qtdsod`` (Tiny-DSOD), VOC geometry
(21 classes, 300x300, 8,732 / 8,744 priors), qnnpack, full width and depth,
``frostnet_tpu_torch/testdata`` holds what the JAX package computes from
weights both packages can make, so that ``chip_smoke.py`` phase 18 can hold
the port against the reference on the GPU without JAX. No weights are
committed:

* ``det_<net>_calibration.npz``: on top of ``numpy_init((feat, head), 0)``,
  each feature-net BN's shift (``params/feat/.../bias_bn``, drawn from
  ``N(BN_SHIFT)`` with ``RandomState(1)`` in key order), each BN's running
  statistics, the feature net's and the head's (the mean, over
  ``BN_FORWARDS`` float forwards in train mode, of the batch statistics,
  read back through the momentum update from zeroed ones), the head's conf
  BN scales set to ``CONF_GAIN`` (so that the softmax clears the server's
  0.25 threshold at some priors) and every observer (two QAT forwards of
  the feature net in eval mode), as flat keys of the ``Detector`` tree. The
  images are ``RandomState(2).randn(2, 300, 300, 3)``.
* ``det_<net>_reference.npz``: for ``RandomState(0).randn(2, 300, 300, 3)``,
  the frozen JAX feature net served from its own INT8 artifacts
  (``freeze(load_int8(export_int8(variables)))``), then the float head:
  ``sha256/<layer>`` (per image), ``shape/<layer>`` and ``hist/<layer>``
  for every top-level module whose codes it computes and for each
  dequantized source (``source0`` ... ``source5``, float32 bytes);
  ``loc_sampled`` and ``conf_sampled`` (every ``DET_PRIOR_STRIDE``-th prior)
  and ``detections``, ``detect``'s (2, 21, 50, 5) output at the server's
  settings.

``det_qssd_train_reference.npz`` holds the JAX trainer's step
(``make_det_train_step``) from the calibrated qssd fixture
(``chip_smoke.det_train_variables``: ``numpy_init`` and the calibration
above, the head's conf scales at 1) at 300x300, batch 2, float32: one FP32
step, ``set_warmup(False)``, two QAT steps, then
a QAT_FROZEN eval of the loss (QSGD under the trainer's multistep schedule
at lr 1e-3, momentum 0.9, weight decay 5e-4, ``clip_by`` 1e-3,
``noise_decay=1.0``: the GradBoost noise exactly 0). It starts calibrated
because from empty observers the first QAT forward observes a grid that
one flipped code moves: at ``block1/expand`` half the values then differ,
between the port on 2 and on 8 CPU threads alone (QAT losses 1.2% apart;
against JAX 4.2%, loc loss 17%). Batch ``k`` is
``chip_smoke.det_train_batch(k)``. Keys: ``loss``, ``loss_l``, ``loss_c``
(4,), every observer and BN statistic after the last step, ``__meta__``.

Regenerate with ``python tests/test_torch_det_fixture.py`` (about 10 CPU
minutes). Under pytest this file checks the fixtures' keys and spread, and
serves the first image of each net through the port on the CPU, layer by
layer, against the digests, loc and conf within ``DET_HEAD_BAND`` and the
kept boxes within ``DET_BOX_BAND``.
"""
import json
import os
import sys
import tempfile

import numpy as np
import pytest

from _torch_port import few_threads  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("few_threads")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script (python tests/test_torch_det_fixture.py)
    sys.path.insert(0, ROOT)
from chip_smoke import (DET_CLASSES as CLASSES, DET_NETS as NETS,  # noqa: E402
                        DET_PRIOR_STRIDE, DET_SERVE, DET_SIZE as SIZE, DET_TRAIN_REFERENCE,
                        TESTDATA)
BATCH, BN_FORWARDS = 2, 2
BN_SHIFT = (0.5, 0.5)  # mean and std of the feature net's BN shifts
CONF_GAIN = 3.0        # the head's conf BN scale
TRAIN = dict(net="qssd", batch=2, seed=0, lr=1e-3, momentum=0.9, wd=5e-4, clip_by=1e-3,
             start="calibrated")


def _paths(net):
    return (os.path.join(TESTDATA, f"det_{net}_calibration.npz"),
            os.path.join(TESTDATA, f"det_{net}_reference.npz"))


def jax_pair(net):
    from frostnet_tpu.detection import build_ssd, build_tdsod

    return (build_tdsod if net == "qtdsod" else build_ssd)(num_classes=CLASSES)


def jax_priors(net):
    from frostnet_tpu.detection.anchors import make_priors
    from frostnet_tpu.detection.train import select_config

    return make_priors(select_config(net, "voc"))


def calibrate_jax(net, batch=BATCH, bn_forwards=BN_FORWARDS, seed=0):
    """(feat, head, feat_vars, head_vars) of the JAX package:
    ``numpy_init((feat, head), seed)`` of the port's nets with seeded BN
    shifts, the conf gain, BN statistics from ``bn_forwards`` float train
    forwards and the observers from two QAT eval forwards
    (``RandomState(seed + 2)`` images)."""
    import jax
    import jax.numpy as jnp

    from _torch_port import jax_variables
    from frostnet_tpu import nn as jnn
    from frostnet_tpu.nn.conv import QConvBNAct
    from frostnet_tpu_torch.detection.train import build_net
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables

    fv, hv = numpy_init(build_net(net, CLASSES), seed)
    flat = flatten_variables(fv)
    rng = np.random.RandomState(seed + 1)
    for k in sorted(flat):
        if k.endswith("/bias_bn"):
            flat[k] = rng.normal(*BN_SHIFT, flat[k].shape).astype(np.float32)
    hflat = flatten_variables(hv)
    for k in hflat:
        if k.startswith("params/") and "/conf" in k and k.endswith("/scale"):
            hflat[k] = np.full_like(hflat[k], CONF_GAIN)
    jfv = jax_variables(unflatten_variables(flat))
    jhv = jax_variables(unflatten_variables(hflat))
    feat, head = jax_pair(net)
    rng = np.random.RandomState(seed + 2)

    def draw():
        return jnp.asarray(rng.randn(batch, SIZE, SIZE, 3).astype(np.float32))

    m = QConvBNAct.bn_momentum
    zf = jax.tree.map(jnp.zeros_like, jfv["batch_stats"])
    zh = jax.tree.map(jnp.zeros_like, jhv["batch_stats"])

    @jax.jit
    def bn_forward(fvars, hvars, xb):
        srcs, fu = feat.apply({**fvars, "batch_stats": zf}, xb, mode=jnn.FP32, train=True,
                              mutable=["batch_stats"])
        _, hu = head.apply({**hvars, "batch_stats": zh}, srcs, train=True,
                           mutable=["batch_stats"])
        return fu["batch_stats"], hu["batch_stats"]

    tot = None
    for _ in range(bn_forwards):
        got = jax.tree.map(lambda a: np.asarray(a, np.float64) / m, bn_forward(jfv, jhv, draw()))
        tot = got if tot is None else jax.tree.map(np.add, tot, got)
    fs, hs = jax.tree.map(lambda a: jnp.asarray((a / bn_forwards).astype(np.float32)), tot)
    jfv, jhv = {**jfv, "batch_stats": fs}, {**jhv, "batch_stats": hs}
    observe = jax.jit(lambda v, xb: feat.apply(v, xb, mode=jnn.QAT, train=False,
                                               mutable=["quant"]))
    for _ in range(2):
        _, updates = observe(jfv, draw())
        jfv = {**jfv, **updates}
    return feat, head, jfv, jhv


def jax_det_codes(feat, variables, images):
    """(sources, {layer: codes}) of the frozen JAX feature net (jit closed
    over ``variables``): the QTensor output of every top-level module."""
    import flax.linen as fnn
    import jax

    from frostnet_tpu import nn as jnn
    from frostnet_tpu.quant.qtensor import QTensor

    def fn(x):
        codes = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            path = context.module.scope.path
            if context.method_name == "__call__" and len(path) == 1 and isinstance(out, QTensor):
                codes[path[0]] = out.q
            return out

        with fnn.intercept_methods(record):
            sources = feat.apply(variables, x, mode=jnn.INT8)
        return sources, codes

    sources, codes = jax.jit(fn)(images)
    return [np.asarray(s) for s in sources], {k: np.asarray(v) for k, v in codes.items()}


def jax_serve(feat, head, feat_vars, head_vars, images, priors):
    """The JAX server's program (``serve.py`` ``_build_det``): the frozen
    feature net and the head in one jit closed over the variables, then
    ``detect`` at the server's settings. Returns (sources, loc, conf, dets)."""
    import jax
    import jax.numpy as jnp

    from frostnet_tpu import nn as jnn
    from frostnet_tpu.detection.nms import detect

    @jax.jit
    def fn(x):
        srcs = feat.apply(feat_vars, x, mode=jnn.INT8)
        return srcs, head.apply(head_vars, srcs)

    srcs, (loc, conf) = fn(images)
    dets = detect(loc, jax.nn.softmax(conf, axis=-1), jnp.asarray(priors), **DET_SERVE)
    return ([np.asarray(s) for s in srcs], np.asarray(loc), np.asarray(conf),
            np.asarray(dets))


def _digests(layers, name, v):
    import torch

    from chip_smoke import code_digests

    layers[f"sha256/{name}"] = np.asarray(code_digests(torch.as_tensor(v)))
    layers[f"shape/{name}"] = np.asarray(v.shape, np.int64)
    if v.dtype == np.uint8:
        layers[f"hist/{name}"] = np.bincount(v.ravel(), minlength=256).astype(np.int64)


def make_fixture(net):
    import jax
    import jax.numpy as jnp

    from frostnet_tpu.quant import export_int8, load_int8
    from frostnet_tpu_torch.detection.models import join_variables
    from frostnet_tpu_torch.quant.export import flatten_variables

    jax.config.update("jax_default_matmul_precision", "highest")
    feat, head, fv, hv = calibrate_jax(net)
    calibrated = flatten_variables(join_variables(*jax.tree.map(np.asarray, (fv, hv))))
    keep = {k: v for k, v in calibrated.items()
            if not k.startswith("params/") or k.endswith("/bias_bn") or
            (k.startswith("params/head/") and k.endswith("/scale"))}
    calibration, reference = _paths(net)
    os.makedirs(TESTDATA, exist_ok=True)
    np.savez_compressed(calibration, **keep)
    with tempfile.TemporaryDirectory() as tmp:
        export_int8(fv, os.path.join(tmp, "feat.npz"))
        export_int8(hv, os.path.join(tmp, "head.npz"))
        sfv, shv = load_int8(os.path.join(tmp, "feat.npz")), load_int8(os.path.join(tmp, "head.npz"))
    images = jnp.asarray(np.random.RandomState(0).randn(BATCH, SIZE, SIZE, 3).astype(np.float32))
    srcs, codes = jax_det_codes(feat, sfv, images)
    served, loc, conf, dets = jax_serve(feat, head, sfv, shv, images, jax_priors(net))
    for a, b in zip(srcs, served):  # the recording program rounds as the served one
        np.testing.assert_array_equal(a, b)
    layers = {}
    for k, v in codes.items():
        _digests(layers, k, v)
    for i, s in enumerate(served):
        _digests(layers, f"source{i}", s)
    np.savez_compressed(reference, loc_sampled=loc[:, ::DET_PRIOR_STRIDE],
                        conf_sampled=conf[:, ::DET_PRIOR_STRIDE], detections=dets,
                        image_seed=np.int64(0), **layers)
    return codes, dets


def make_train_reference(path=DET_TRAIN_REFERENCE):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")
    from _torch_port import jax_variables
    from chip_smoke import det_train_batch, det_train_variables
    from frostnet_tpu.detection.losses import multibox_loss
    from frostnet_tpu.detection.train import DetState, make_det_train_step, select_config
    from frostnet_tpu.nn import FP32, QAT, QAT_FROZEN
    from frostnet_tpu.optim import get_optimizer, schedules, set_warmup
    from frostnet_tpu_torch.detection.models import join_variables
    from frostnet_tpu_torch.quant.export import flatten_variables

    net = TRAIN["net"]
    det_cfg = select_config(net, "synthetic")
    fv, hv = (jax_variables(t) for t in det_train_variables(net))
    feat, head = jax_pair(net)
    priors = jnp.asarray(jax_priors(net))
    tx = get_optimizer("QSGD", schedules.multistep(TRAIN["lr"], det_cfg["lr_steps"], 0.1),
                       momentum=TRAIN["momentum"], weight_decay=TRAIN["wd"],
                       clip_by=TRAIN["clip_by"], noise_decay=1.0)
    state = DetState(step=jnp.zeros([], jnp.int32), feat_params=fv["params"],
                     feat_batch_stats=fv["batch_stats"], feat_quant=fv["quant"],
                     head_params=hv["params"], head_batch_stats=hv["batch_stats"],
                     opt_state=tx.init((fv["params"], hv["params"])),
                     rng=jax.random.PRNGKey(0), tx=tx)
    losses = []
    for k, mode in enumerate((FP32, QAT, QAT)):
        if k == 1:
            state = state.replace(opt_state=set_warmup(state.opt_state, False))
        step = make_det_train_step(feat, head, mode, priors, CLASSES)
        state, m = step(state, {kk: jnp.asarray(v) for kk, v in det_train_batch(k).items()})
        losses.append([float(m[kk]) for kk in ("loss", "loss_l", "loss_c")])
        print(f"step {k}: losses {losses[-1]}", flush=True)

    @jax.jit
    def eval_loss(st, b):
        srcs = feat.apply({"params": st.feat_params, "batch_stats": st.feat_batch_stats,
                           "quant": st.feat_quant}, b["image"], mode=QAT_FROZEN)
        loc, conf = head.apply({"params": st.head_params, "batch_stats": st.head_batch_stats},
                               srcs)
        ll, lc = multibox_loss(loc, conf, b["boxes"], b["labels"], b["valid"], priors)
        return ll + lc, ll, lc

    out = eval_loss(state, {kk: jnp.asarray(v) for kk, v in det_train_batch(3).items()})
    losses.append([float(v) for v in out])
    print(f"eval: losses {losses[-1]}", flush=True)
    tree = jax.tree.map(np.asarray, join_variables(
        {"batch_stats": state.feat_batch_stats, "quant": state.feat_quant},
        {"batch_stats": state.head_batch_stats}))
    flat = flatten_variables(tree)
    meta = dict(TRAIN, classes=CLASSES, size=SIZE, steps=["FP32", "set_warmup(False)", "QAT",
                                                          "QAT", "QAT_FROZEN eval"],
                jax=jax.__version__)
    arr = np.asarray(losses, np.float32)
    np.savez_compressed(path, loss=arr[:, 0], loss_l=arr[:, 1], loss_c=arr[:, 2],
                        __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                        **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    print("wrote", path, "losses", losses)


def load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def layers_of(ref):
    return sorted(k[len("sha256/"):] for k in ref if k.startswith("sha256/"))


@pytest.mark.parametrize("net", NETS)
def test_fixture_keys_and_spread(net):
    """The calibration covers every BN and observer of the port's nets; the
    reference's code maps are varied and every image its own; loc and conf
    are finite, and the server's detect keeps boxes in several classes."""
    from chip_smoke import det_variables
    from frostnet_tpu_torch.detection.models import Detector
    from frostnet_tpu_torch.detection.train import build_net
    from frostnet_tpu_torch.quant import model_variables
    from frostnet_tpu_torch.quant.export import flatten_variables

    calibration, reference = _paths(net)
    cal = load(calibration)
    mine = model_variables(Detector(*build_net(net, CLASSES)))
    want = {k for k in mine if not k.startswith("params/") or k.endswith("/bias_bn")
            or (k.startswith("params/head/") and k.endswith("/scale"))}
    assert set(cal) == want
    assert all(np.isfinite(v).all() for t in det_variables(net)
               for v in flatten_variables(t).values())
    ref = load(reference)
    layers = layers_of(ref)
    assert {f"source{i}" for i in range(6)} <= set(layers)
    assert "quant" in layers and ("extra5" in layers if net == "qssd" else "qadd5" in layers)
    for layer in layers:
        assert len(set(ref[f"sha256/{layer}"])) == BATCH, layer
        if f"hist/{layer}" in ref and ref[f"shape/{layer}"][1] > 3:
            hist = ref[f"hist/{layer}"]
            assert (hist > 0).sum() >= 16 and hist.max() <= 0.75 * hist.sum(), layer
    assert np.isfinite(ref["loc_sampled"]).all() and np.isfinite(ref["conf_sampled"]).all()
    kept = ref["detections"][..., 0] > 0
    assert kept[:, 0].sum() == 0 and kept.any(axis=(0, 2)).sum() >= 3


@pytest.mark.parametrize("net", NETS)
def test_port_matches_fixture_layer_by_layer(net):
    """The port on the CPU, from ``numpy_init`` and the committed calibration
    through its own ``export_int8`` and ``serve.DetPredictor``, against the
    frozen JAX graph's committed codes, sources, head and detections, first
    image."""
    from chip_smoke import check_det_layers, det_layer_codes, det_outputs_check, det_served

    images = np.random.RandomState(0).randn(1, SIZE, SIZE, 3).astype(np.float32)
    pred = det_served(net, "cpu")
    (loc, conf), sources, codes = det_layer_codes(pred, images)
    ref = np.load(_paths(net)[1])
    layers = check_det_layers(net, {k: v[:1] for k, v in codes.items()}, sources, ref)
    assert len(layers) == len(codes) + 6
    det_outputs_check(net, loc, conf, pred.priors, ref)


def test_train_reference_keys():
    from chip_smoke import det_train_batch
    from frostnet_tpu_torch.detection.models import Detector
    from frostnet_tpu_torch.detection.train import build_net
    from frostnet_tpu_torch.quant import model_variables

    ref = load(DET_TRAIN_REFERENCE)
    mine = model_variables(Detector(*build_net(TRAIN["net"], CLASSES)))
    want = {k for k in mine if not k.startswith("params/")}
    assert {k for k in ref if k not in ("loss", "loss_l", "loss_c", "__meta__")} == want
    for k in ("loss", "loss_l", "loss_c"):
        assert ref[k].shape == (4,) and np.isfinite(ref[k]).all()
    assert det_train_batch(0)["valid"].any()
    assert json.loads(bytes(ref["__meta__"]).decode())["net"] == TRAIN["net"]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    which = sys.argv[1:] or list(NETS) + ["train"]
    for name in which:
        if name == "train":
            make_train_reference()
            continue
        codes, dets = make_fixture(name)
        kept = dets[..., 0] > 0
        print(name, "kept boxes", int(kept.sum()), "classes", np.unique(np.nonzero(kept)[1]))
        for layer in sorted(codes):
            c = codes[layer]
            print(f"  {layer:24s} {c.shape} distinct {len(np.unique(c))}")
