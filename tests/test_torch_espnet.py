"""PyTorch port, ESPNetv2 and ESPNet (``segmentation/espnet.py``), against JAX.

The same variables and inputs, made from numpy seeds, go through the JAX
function and the port's:

* ``avg_pool_3x3_s2`` on codes: the window sums with code 0 (not the zero
  point) in the padding, times ``f32(1/9)``, rounded half to even, clipped;
  bit-equal to JAX at odd and even sizes, borders included (a zero-point
  padding would differ there). On floats within 2 ulps (XLA's window sum
  is sequential in float32; the port's exact, rounded once).
* The registry: ``espnet`` and ``espnetv2`` build with JAX's variables
  (20 classes by default, ``dataset`` dropped, ``s`` the width scale).
* INT8: ``ESPNetv2Seg`` (s 0.5, 64x64, qnnpack) and ``ESPNetSeg`` (p 1,
  q 1, 64x64, qnnpack and fbgemm), BN shifts drawn, calibrated in JAX: the
  codes of every module of the port's frozen graph equal JAX ``freeze()``'s,
  bit for bit; the float tail's logits within ``LOGIT_REL`` of their span.
  The port's ``export_int8`` equals JAX's array for array.
* The rounding of each observed add (``QADD_LOADED``): read from XLA's
  optimized HLO of the frozen models, every EESP, DownSampler and ESPBlock
  add makes both operands' codes in its own fusion (XLA fuses their
  producers into it), so none contracts a product; pinned add by add.
* Training: ESPNet's FP32 step, QAT step and QAT_FROZEN eval step (p 1,
  q 1) against the jitted JAX steps, in the bands of
  ``tests/test_torch_train_step.py``; ESPNetv2's FP32 and QAT train-mode
  forwards (logits, BN statistics, observers) in those bands.
* The user's path: the segmentation trainer and evaluator with
  ``--model espnetv2 --width_scale 0.5`` and ``--model espnet`` on the CPU.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_train_state, jax_variables  # noqa: F401
from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu.segmentation import espnet as jesp
from frostnet_tpu.segmentation import get_seg_model as jax_seg_model
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.quant import (QParams, QTensor, export_int8, freeze, from_jax_variables,
                                      get_qconfig, model_variables, numpy_init)
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
from frostnet_tpu_torch.segmentation import espnet as tesp
from frostnet_tpu_torch.segmentation import get_seg_model
from test_torch_train_step import FP32_LOSS_REL, QAT_LOSS_REL
from test_torch_zoo import (_flat_shapes, assert_codes_equal, calibrated, jax_module_codes,
                            port_module_codes, shifted_tree)

pytestmark = pytest.mark.usefixtures("few_threads")
SIZE, CLASSES = 64, 20
P, Q = 1, 1  # ESPNet's depths (the full model: 2 and 8)
LOGIT_REL = 1e-5  # the float tail (1x1 conv, resize): sums in another order than XLA's


# ---------------------------------------------------------------------------
# avg_pool_3x3_s2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 8, 9, 16])
def test_avg_pool_codes_pad_with_code_zero(n):
    rng = np.random.RandomState(n)
    q = rng.randint(0, 256, (2, n, n, 5)).astype(np.uint8)
    zp = 131
    want = np.asarray(jax.jit(lambda qq: jesp._avg_pool_3x3_s2(
        JQTensor(qq, jnp.float32(0.02), jnp.int32(zp))).q)(jnp.asarray(q)))
    got = tesp.avg_pool_3x3_s2(QTensor(torch.as_tensor(q), *QParams(0.02, zp).tensors("cpu")))
    np.testing.assert_array_equal(got.q.numpy(), want)
    # padding with the zero point instead would move the border windows
    padded = np.pad(q.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=zp)
    corner = np.round(padded[:, :3, :3].sum(axis=(1, 2)) * np.float32(1 / 9))
    assert (corner != want[:, 0, 0]).any()
    assert (want[:, 1:, 1:] != 0).all() or n < 9  # interior windows are full


def test_avg_pool_floats():
    x = (np.random.RandomState(3).randn(2, 13, 13, 8) * 4).astype(np.float32)
    want = np.asarray(jax.jit(jesp._avg_pool_3x3_s2)(jnp.asarray(x)))
    got = tesp.avg_pool_3x3_s2(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=4e-7)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("espnetv2", {}), ("espnetv2", {"s": 2.0}),
                                     ("espnet", {}), ("espnet", {"num_classes": 19})])
def test_variables_match_jax(name, kw):
    port = get_seg_model(name, dataset="city", **kw)
    assert port.num_classes == kw.get("num_classes", 20)
    jm = jax_seg_model(name, dataset="city", **kw)
    want = _flat_shapes(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                       jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)))
    assert {k: tuple(v.shape) for k, v in model_variables(port).items()} == want


# ---------------------------------------------------------------------------
# INT8 against JAX freeze()
# ---------------------------------------------------------------------------

def _models(name, backend="qnnpack"):
    if name == "espnetv2":
        return (jesp.ESPNetv2Seg(num_classes=CLASSES, s=0.5, qconfig=jq.get_qconfig(backend)),
                tesp.ESPNetv2Seg(num_classes=CLASSES, s=0.5, qconfig=get_qconfig(backend)))
    return (jesp.ESPNetSeg(num_classes=CLASSES, p=P, q=Q, qconfig=jq.get_qconfig(backend)),
            tesp.ESPNetSeg(num_classes=CLASSES, p=P, q=Q, qconfig=get_qconfig(backend)))


@pytest.fixture(scope="module")
def calibrated_v2():
    jm, tm = _models("espnetv2")
    return jm, tm, calibrated(jm, shifted_tree(tm), SIZE)


@pytest.mark.parametrize("name,backend", [("espnetv2", "qnnpack"), ("espnet", "qnnpack"),
                                          ("espnet", "fbgemm")])
def test_int8_codes_bit_equal(name, backend, calibrated_v2):
    if name == "espnetv2":
        jm, tm, tree = calibrated_v2
    else:
        jm, tm = _models(name, backend)
        tree = calibrated(jm, shifted_tree(tm), SIZE)
    images = np.random.RandomState(5).randn(2, SIZE, SIZE, 3).astype(np.float32)
    jout, jcodes = jax_module_codes(jm, jax_variables(tree), images)
    from_jax_variables(tm, tree)
    out, codes = port_module_codes(tm, freeze(tm, "cpu", SIZE), images)
    assert_codes_equal(jcodes, codes)
    assert out.shape == jout.shape == (2, SIZE, SIZE, CLASSES)
    assert np.abs(out - jout).max() <= LOGIT_REL * float(jout.max() - jout.min())
    routes = {}
    for m in tm.modules():
        if isinstance(m, tnn.QConvBNAct) and m.quantized:
            routes.setdefault(m._route, set()).add((m.in_features, m.features))
    if name == "espnetv2":  # the reinforcement's 3x3 of the raw image: 3 -> 3
        assert set(routes) == {"im2col", "matmul", "depthwise", "grouped", "dense3x3"}
        assert routes["dense3x3"] == {(3, 3)}
    else:  # ESPBlock's d1 branches and the decoder's conv, 39 -> 20
        assert set(routes) == {"im2col", "matmul", "dense3x3"}
        assert (CLASSES + 19, CLASSES) in routes["dense3x3"] and (25, 28) in routes["dense3x3"]


def test_export_equals_jax(calibrated_v2, tmp_path):
    _, tm, tree = calibrated_v2
    from_jax_variables(tm, tree)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    export_int8(tm, mine)
    jq.export_int8(jax_variables(tree), theirs)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# The observed adds' rounding, read from the frozen graph
# ---------------------------------------------------------------------------

def add_operand_origins(hlo: str, top: str):
    """``{add path: {(origin of operand 0, origin of operand 1)}}`` over the
    observed adds of the optimized HLO (a sum of two products whose op name
    ends in ``quant_add<i>/add`` or ``skip_add/add``): an operand's codes are
    ``loaded`` (a u8 parameter of the fusion) or ``made`` (a u8 convert in
    it)."""
    found = {}
    for body in hlo.split("\n\n"):
        defs = {}
        for line in body.splitlines():
            m = re.match(r"\s*(?:ROOT )?%([\w.\-]+) = (\S+) ([\w\-]+)\((.*?)\)", line)
            if m:
                defs[m.group(1)] = (m.group(2), m.group(3),
                                    [a.strip().lstrip("%") for a in m.group(4).split(",")], line)

        def origin(name, depth=0):
            if name not in defs or depth > 8:
                return None
            ty, op, args, _ = defs[name]
            if op == "parameter":
                return "loaded" if ty.startswith("u8") else None
            if op == "convert" and ty.startswith("u8"):
                return "made"
            return next((o for o in (origin(a, depth + 1) for a in args) if o), None)

        for ty, op, args, line in defs.values():
            m = re.search(rf"{top}/([\w/]*?(?:quant_add\d|skip_add))/add\"", line)
            if op == "add" and m and all(defs.get(a, ("", ""))[1] == "multiply"
                                         for a in args[:2]):
                found.setdefault(m.group(1), set()).add(tuple(origin(a) for a in args[:2]))
    return found


@pytest.mark.parametrize("name,top,n_adds", [("espnetv2", "ESPNetv2Seg", 55),
                                             ("espnet", "ESPNetSeg", 17)])
def test_observed_adds_make_both_operands(name, top, n_adds):
    """The frozen graph (64x64, batch 1, random grids) of each model: every
    observed add's fusion makes both operands' codes, so ``QADD_LOADED`` is
    empty and each add of the port rounds both products and the sum on
    their own (``QAdd._contract`` None); the same holds at 128x128."""
    jm, tm = _models(name)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        key = getattr(path[-1], "name", getattr(path[-1], "key", ""))
        if key in ("min_val", "max_val"):
            return jnp.full(leaf.shape, rng.uniform(0.5, 3) * (1 if key == "max_val" else -1),
                            jnp.float32)
        if key in ("scale", "var"):
            return jnp.ones(leaf.shape, jnp.float32)
        return jnp.asarray(rng.randn(*leaf.shape).astype(np.float32) * 0.1)

    v = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jm.init, jax.random.PRNGKey(0), x))
    hlo = jax.jit(lambda xx: jm.apply(v, xx, mode=jnn.INT8)).lower(x).compile().as_text()
    found = add_operand_origins(hlo, top)
    assert len(found) == n_adds
    loaded = {path: tuple(o == "loaded" for o in pair) for path, pairs in found.items()
              for pair in pairs if "loaded" in pair}
    assert loaded == tesp.QADD_LOADED == {}
    assert all(pairs == {("made", "made")} for pairs in found.values())
    from_jax_variables(tm, unflatten_variables(flatten_variables(jax.tree.map(np.asarray, v))))
    tm.prepare_int8("cpu", SIZE)
    adds = {n: m._contract for n, m in tm.named_modules() if isinstance(m, tnn.QAdd)}
    assert len(adds) == n_adds and set(adds.values()) == {None}
    assert {n.replace(".", "/") for n in adds} == set(found)


# ---------------------------------------------------------------------------
# Training against the jitted JAX steps
# ---------------------------------------------------------------------------

def _seg_batch(k, batch=2, size=SIZE):
    rng = np.random.RandomState(300 + k)
    label = rng.randint(0, CLASSES, (batch, size, size)).astype(np.int32)
    label.reshape(-1)[::19] = 255
    return {"image": rng.randn(batch, size, size, 3).astype(np.float32), "label": label}


@pytest.mark.parametrize("name", ["espnet"])
def test_train_steps_within_bands(name):
    from frostnet_tpu.optim import get_optimizer as jax_optimizer
    from frostnet_tpu.optim import grouped_weight_decay as jax_gwd
    from frostnet_tpu.segmentation.train import make_seg_eval_step as jax_eval
    from frostnet_tpu.segmentation.train import make_seg_train_step as jax_step
    from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu_torch.segmentation import train as seg_train
    from frostnet_tpu_torch.train import create_train_state

    jm, tm = _models(name)
    tree = numpy_init(tm, 0)
    js = jax_train_state(jm, tree, jax_optimizer("QSGD", 1e-3, weight_decay=jax_gwd(4e-5),
                                                 noise_decay=1.0))
    tx = get_optimizer("QSGD", 1e-3, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(tm, tx, seed=0, device="cpu", variables=tree)
    losses, jlosses = [], []
    for k, (jmode, tmode) in enumerate(((jnn.FP32, tnn.FP32), (jnn.QAT, tnn.QAT))):
        if k == 1:
            js = js.start_qat()
            state.start_qat()
        js, m = jax_step(jm, jmode, None, 255, CLASSES)(js, _seg_batch(k))
        jlosses.append(float(m["loss"]))
        losses.append(float(seg_train.make_seg_train_step(tmode, None, 255, CLASSES)(
            state, _seg_batch(k))["loss"]))
    assert abs(losses[0] - jlosses[0]) <= FP32_LOSS_REL * jlosses[0], (losses, jlosses)
    assert abs(losses[1] - jlosses[1]) <= QAT_LOSS_REL * jlosses[1], (losses, jlosses)
    jcm = np.asarray(jax_eval(jm, jnn.QAT_FROZEN, CLASSES, 255)(js, _seg_batch(2)))
    cm = seg_train.make_seg_eval_step(tnn.QAT_FROZEN, CLASSES, 255)(state, _seg_batch(2)).numpy()
    assert cm.sum() == jcm.sum() > 0


@pytest.mark.parametrize("phase", ["FP32", "QAT"])
def test_espnetv2_train_forwards_within_bands(phase):
    """ESPNetv2's train-mode forward (its JAX train step takes minutes to
    compile on the CPU; the whole step is held against a committed JAX
    reference on the card, ``chip_smoke.py`` phase 20): from one
    ``numpy_init`` tree, the logits (FP32 within ``FP32_LOSS_REL`` of their
    span, QAT within ``QAT_LOSS_REL``), every BN statistic within 1e-4 of a
    std (FP32) and every observer within 1% of its range in the median (QAT)
    of JAX's."""
    jm, tm = _models("espnetv2")
    jmode, tmode = {"FP32": (jnn.FP32, tnn.FP32), "QAT": (jnn.QAT, tnn.QAT)}[phase]
    tree = shifted_tree(tm)
    x = _seg_batch(0)["image"]
    jy, upd = jax.jit(lambda vv, xx: jm.apply(vv, xx, mode=jmode, train=True,
                                              mutable=["batch_stats", "quant"]))(
        jax_variables(tree), jnp.asarray(x))
    from_jax_variables(tm, tree)
    ty = tm(torch.as_tensor(x), mode=tmode, train=True).detach().numpy()
    jy = np.asarray(jy)
    band = FP32_LOSS_REL if phase == "FP32" else QAT_LOSS_REL
    assert np.abs(ty - jy).max() <= band * float(jy.max() - jy.min())
    jflat = flatten_variables(jax.tree.map(np.asarray, upd))
    mine = {k: v.detach().numpy() for k, v in model_variables(tm).items()}
    if phase == "FP32":
        for k in jflat:
            if k.endswith("/mean"):
                std = np.sqrt(jflat[k[:-len("mean")] + "var"])
                assert np.max(np.abs(mine[k] - jflat[k]) / std) <= 1e-4, k
        return
    rel = []
    for k in jflat:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(np.max(jflat[hi] - jflat[k])), 1e-6)
            rel.append(float(np.max(np.maximum(np.abs(mine[k] - jflat[k]),
                                               np.abs(mine[hi] - jflat[hi])))) / span)
    assert len(rel) > 200 and np.median(rel) <= 0.01, np.median(rel)


# ---------------------------------------------------------------------------
# The user's path on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,extra", [("espnetv2", ["--width_scale", "0.5"]),
                                         ("espnet", [])])
def test_trainer_and_evaluator(tmp_path, capsys, model, extra):
    """``train.cli`` (one FP32 and one QAT epoch of one step at 32x32), then
    ``evaluate.main`` on its ``best`` checkpoint with ``--export_int8``: the
    artifact fills a fresh model, whose frozen forward gives the mIoU the
    evaluator reports."""
    from frostnet_tpu_torch.segmentation import evaluate, train

    save = tmp_path / "run"
    train.cli(["--device", "cpu", "--model", model, "--dataset", "synthetic", "--crop_size", "32",
               "--batch_size", "2", "--steps_per_epoch", "1", "--epochs", "1", "--fp_epochs",
               "1", "--save_dir", str(save)] + extra)
    assert "mIoU(INT8 frozen)=" in capsys.readouterr().out
    artifact = str(tmp_path / "int8.npz")
    res = evaluate.main(evaluate.build_parser().parse_args(
        ["--model", model, "--checkpoint", str(save / "best"), "--dataset", "synthetic",
         "--crop_size", "32", "--export_int8", artifact, "--device", "cpu"] + extra))
    assert np.isfinite(res["qat"]) and np.isfinite(res["int8"])
    with np.load(artifact) as a:
        assert any(k.endswith("inp_reinf0/kernel") for k in a.files) == (model == "espnetv2")
