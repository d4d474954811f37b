"""PyTorch port, the ResNet family (``models/resnet.py``) and its pieces, against JAX.

The same variables and inputs, made from numpy seeds, go through the JAX
function and the port's:

* ``max_pool`` with ``_pad1``'s padding: codes padded with the zero point,
  floats with ``-inf``; outputs bit-equal, and the float gradient too (ties
  go to the first maximum of a window in both).
* ``QAddReLU``: FP32, QAT and QAT_FROZEN bit-equal (output and observer);
  INT8 bit-equal on every pair of input codes to the add as XLA's fusion
  rounds it: no product contracted where it makes both operands' codes, the
  product of the first operand it loads from memory contracted otherwise
  (the first BasicBlock's pooled identity; pinned on a pool and a block).
* The grouped INT8 route (ResNeXt's 3x3s): groups 32 and 4, stride 1 and 2,
  with and without ReLU, qnnpack and fbgemm: codes bit-equal to the frozen
  JAX conv.
* A BasicBlock with a downsample, a Bottleneck with a downsample and a
  grouped Bottleneck: INT8 codes bit-equal to the frozen JAX block.
* Small whole models, ``ResNet(block, layers=(1, 1, 1, 1), num_classes=10)``
  at 32x32 (BasicBlock, Bottleneck, grouped Bottleneck; qnnpack and
  fbgemm), calibrated in JAX: the port's ``export_int8`` equals JAX's
  array for array, and the codes of every top-level layer, the pooled
  codes and the logits of the port serving its own artifact equal JAX
  ``freeze()`` of JAX's, bit for bit.
* Training a small BasicBlock model: one FP32 step, one QAT step and a
  QAT_FROZEN eval step against the jitted JAX steps within the bands of
  ``tests/test_torch_train_step.py``; the float model's eval forward and SGD
  step within those of ``tests/test_torch_mobilenet_train.py``.
* The registry: the 12 ResNet names build with JAX's variables;
  ``grouped_weight_decay`` groups a ResNeXt's parameters as JAX does; the
  trainer -> evaluator -> ``serve.main`` path runs ``qresnet18`` on the CPU.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_train_state, jax_variables, train_batch  # noqa: F401
from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu.models import create_model as jax_create_model
from frostnet_tpu.models import resnet as jres
from frostnet_tpu.nn.pool import max_pool as jax_max_pool
from frostnet_tpu.optim import get_optimizer as jax_optimizer
from frostnet_tpu.optim import grouped_weight_decay as jax_gwd
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu.train.state import make_eval_step as jax_eval_step
from frostnet_tpu.train.state import make_train_step as jax_train_step
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.models import create_model, list_models
from frostnet_tpu_torch.models import resnet as tres
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import (QParams, QTensor, export_int8, freeze, from_jax_variables,
                                      get_qconfig, load_int8, model_variables)
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
from frostnet_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from test_torch_mobilenet_train import FLOAT_REL, TRAIN_LOSS_REL, UPDATE_REL
from test_torch_train_step import FP32_LOSS_REL, QAT_LOSS_REL

pytestmark = pytest.mark.usefixtures("few_threads")
CLASSES = 10
NAMES = [f"{q}{n}" for q in ("", "q") for n in ("resnet18", "resnet34", "resnet50", "resnet101",
                                                "resnet152", "resnext101_32x8d")]


# ---------------------------------------------------------------------------
# max_pool with _pad1's padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [9, 16])
def test_max_pool_codes_pad_with_the_zero_point(size):
    """Codes: the zero point pads (so a window of codes below it at the
    border keeps the zero point, as JAX's does); bit-equal."""
    rng = np.random.RandomState(size)
    q = rng.randint(0, 256, (2, size, size, 8)).astype(np.uint8)
    zp = 140
    jout = jax.jit(lambda qq: jax_max_pool(
        jres._pad1(JQTensor(qq, jnp.float32(0.02), jnp.int32(zp))), 3, 2, "VALID").q)(
        jnp.asarray(q))
    x = QTensor(torch.as_tensor(q), *QParams(0.02, zp).tensors("cpu"))
    for known in (None, zp):
        got = tnn.max_pool(x, 3, 2, padding=1, zero_point=known).q.numpy()
        np.testing.assert_array_equal(got, np.asarray(jout))
    border = np.asarray(jout)[:, 0, :, :]
    assert (border == zp).any()  # the padding decided some outputs


def test_max_pool_float_and_gradient_with_ties():
    """Floats: ``-inf`` padding, bit-equal output; on fake-quantized values
    (many ties in a window) the gradient goes to the same element as JAX's."""
    rng = np.random.RandomState(3)
    x = (np.round(rng.randn(2, 12, 12, 8) * 2) / 2).astype(np.float32)
    w = rng.randn(2, 6, 6, 8).astype(np.float32)

    def jf(xx):
        return jnp.sum(jax_max_pool(jres._pad1(xx), 3, 2, "VALID") * w)

    jy = np.asarray(jax.jit(lambda xx: jax_max_pool(jres._pad1(xx), 3, 2, "VALID"))(x))
    jg = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = tnn.max_pool(xt, 3, 2, padding=1)
    (y * torch.as_tensor(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), jy)
    np.testing.assert_array_equal(xt.grad.numpy(), jg)


# ---------------------------------------------------------------------------
# QAddReLU
# ---------------------------------------------------------------------------

def _obs(lo=-1.2, hi=5.3):
    return {"act": jq.ObserverState(np.float32(lo), np.float32(hi))}


@pytest.mark.parametrize("phase", ["FP32", "QAT", "QAT_FROZEN"])
def test_add_relu_float_phases_bit_equal(phase):
    jmode, tmode = {"FP32": (jnn.FP32, tnn.FP32), "QAT": (jnn.QAT, tnn.QAT),
                    "QAT_FROZEN": (jnn.QAT_FROZEN, tnn.QAT_FROZEN)}[phase]
    rng = np.random.RandomState(4)
    a = (rng.randn(2, 6, 6, 16) * 2).astype(np.float32)
    b = (rng.randn(2, 6, 6, 16) * 2).astype(np.float32)
    v = jax.tree.map(jnp.asarray, {"quant": _obs()})
    jy, upd = jax.jit(lambda vv, aa, bb: jnn.QAddReLU().apply(vv, aa, bb, mode=jmode,
                                                             mutable=["quant"]))(v, a, b)
    port = from_jax_variables(tnn.QAddReLU(), {"quant": _obs()})
    ty = port(torch.as_tensor(a), torch.as_tensor(b), tmode)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    st = upd["quant"]["act"]
    assert float(port.act.min_val) == float(st.min_val)
    assert float(port.act.max_val) == float(st.max_val)
    if phase == "FP32":
        np.testing.assert_array_equal(ty.numpy(), np.maximum(a + b, 0))


# Grids on which the three roundings of the residual add (no product
# contracted, the first, the second) each give other codes for some pair of
# input codes: all 65536 pairs are fed at once.
ADD_GRIDS = ((np.float32(0.032459888607263565), 11), (np.float32(0.05892854556441307), 146))
ADD_OUT = (np.float32(0.044413935393095016), 45)


def _jax_add_relu(made, qa, qb):
    """The frozen JAX QAddReLU on codes ``qa``, ``qb``; ``made[i]``: operand
    i's codes are made in the same program (a saturating uint8 convert, as a
    conv epilogue makes them) rather than loaded from memory."""
    s, z = ADD_OUT
    mn = np.float32(-z * s)
    obs = {"act": jq.ObserverState(mn, np.float32(mn + 255 * s))}
    consts = jax.tree.map(jnp.asarray, {"quant": obs})

    def fn(fa, fb):
        a = jnp.clip(jnp.round(fa), 0, 255).astype(jnp.uint8) if made[0] else fa
        b = jnp.clip(jnp.round(fb), 0, 255).astype(jnp.uint8) if made[1] else fb
        (sa, za), (sb, zb) = ADD_GRIDS
        return jnn.QAddReLU().apply(consts, JQTensor(a, sa, np.int32(za)),
                                    JQTensor(b, sb, np.int32(zb)), mode=jnn.INT8).q

    args = [jnp.asarray(q, jnp.float32) if m else jnp.asarray(q) for q, m in zip((qa, qb), made)]
    return np.asarray(jax.jit(fn)(*args)), obs


# (made, the port's loaded flags): XLA contracts the product of the first
# operand whose codes the add's fusion loads from memory, none if it makes both
ADD_FUSIONS = [((True, True), (False, False)), ((False, False), (True, True)),
               ((True, False), (False, True)), ((False, True), (True, False))]


@pytest.mark.parametrize("made,loaded", ADD_FUSIONS,
                         ids=["made-made", "loaded-loaded", "made-loaded", "loaded-made"])
def test_add_relu_int8_rounding_follows_the_fusion(made, loaded):
    """INT8: on every pair of input codes, the port's ``QAddReLU`` with the
    operands' ``loaded`` flags gives the frozen JAX add's codes, and the two
    other roundings do not (read from the LLVM IR: a made operand's product
    sits behind its convert's select, a loaded one's is fused into the sum)."""
    qa = np.arange(256).repeat(256).astype(np.uint8).reshape(4, 16, 16, 64)
    qb = np.tile(np.arange(256), 256).astype(np.uint8).reshape(4, 16, 16, 64)
    want, obs = _jax_add_relu(made, qa, qb)
    grids = [QParams(float(s), z) for s, z in ADD_GRIDS]
    got = {}
    for flags in ((False, False), (True, False), (False, True)):
        port = from_jax_variables(tnn.QAddReLU(), {"quant": obs})
        out = port.prepare_int8(grids, "cpu", loaded=flags)
        got[flags] = port(QTensor(torch.as_tensor(qa), None, None),
                          QTensor(torch.as_tensor(qb), None, None), tnn.INT8).q.numpy()
    assert (out.scale, out.zero_point) == (float(ADD_OUT[0]), ADD_OUT[1])
    form = {(False, False): (False, False), (True, True): (True, False)}.get(loaded, loaded)
    np.testing.assert_array_equal(got[form], want)
    assert all((g != want).any() for f, g in got.items() if f != form)
    assert (want == ADD_OUT[1]).mean() > 0.2  # the ReLU clamps many sums at 0


# ---------------------------------------------------------------------------
# The grouped INT8 route
# ---------------------------------------------------------------------------

def _conv_tree(port, rng):
    flat = {k: v.detach().numpy().copy() for k, v in model_variables(port).items()}
    shape = flat["params/kernel"].shape
    flat["params/kernel"] = (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
                             ).astype(np.float32)
    c = shape[-1]
    flat["params/scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    flat["params/bias_bn"] = rng.normal(0.2, 0.3, c).astype(np.float32)
    flat["batch_stats/mean"] = rng.normal(0, 0.1, c).astype(np.float32)
    flat["batch_stats/var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    tree = unflatten_variables(flat)
    return tree


def _calibrated(jmod, tree, xf):
    """The observers after two QAT forwards of the JAX conv in eval mode."""
    v = jax_variables(tree)
    observe = jax.jit(lambda vv, xx: jmod.apply(vv, xx, mode=jnn.QAT, mutable=["quant"]))
    for _ in range(2):
        _, upd = observe(v, jnp.asarray(xf))
        v = {**v, **upd}
    return unflatten_variables(flatten_variables(jax.tree.map(np.asarray, v)))


def _int8_equal(jmod, port, tree, q, grid, mode_kw=None, prepare_kw=None):
    """The port's INT8 codes against the frozen JAX module's, on codes ``q``
    of ``grid`` (a jit argument: loaded from memory); returns the JAX codes."""
    s, zp = grid
    mode_kw = mode_kw or {}
    jout = jax.jit(lambda qq: jmod.apply(jax_variables(tree), JQTensor(
        qq, jnp.float32(s), jnp.int32(zp)), mode=jnn.INT8, **mode_kw))(jnp.asarray(q))
    from_jax_variables(port, tree)
    port.eval()
    g = QParams(float(np.float32(s)), zp)
    out_grid = port.prepare_int8(g, "cpu", **(prepare_kw or {}))
    out = port(QTensor(torch.as_tensor(q), *g.tensors("cpu")), mode=tnn.INT8, **mode_kw)
    assert out_grid.scale == float(jout.scale) and out_grid.zero_point == int(jout.zero_point)
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(jout.q))
    assert len(np.unique(np.asarray(jout.q))) > 16  # a varied output
    return np.asarray(jout.q)


# (groups, cin, stride, act, backend)
GROUPED = [(32, 64, 1, "relu", "qnnpack"), (32, 64, 2, "relu", "fbgemm"),
           (4, 32, 1, None, "fbgemm"), (4, 32, 2, None, "qnnpack")]


@pytest.mark.parametrize("case", GROUPED, ids=lambda c: f"g{c[0]}-s{c[2]}-{c[3]}-{c[4]}")
def test_grouped_conv_int8_bit_equal(case):
    groups, cin, stride, act, backend = case
    rng = np.random.RandomState(groups + stride)
    port = tnn.QConvBNAct(cin, cin, 3, strides=stride, padding=1, groups=groups, act=act,
                          qconfig=get_qconfig(backend))
    jmod = jnn.QConvBNAct(cin, 3, strides=stride, padding=1, groups=groups, act=act,
                          qconfig=jq.get_qconfig(backend))
    qmax = 255 if backend == "qnnpack" else 127
    q = rng.randint(0, qmax + 1, (2, 9, 9, cin)).astype(np.uint8)
    grid = (0.027, qmax // 3)
    xf = ((q.astype(np.float32) - grid[1]) * np.float32(grid[0])).astype(np.float32)
    tree = _calibrated(jmod, _conv_tree(port, rng), xf)
    _int8_equal(jmod, port, tree, q, grid)
    assert port._route == "grouped"


def test_refused_int8_routes():
    """A padded 1x1 conv and a dilated grouped conv stay outside the INT8
    port (a depthwise conv with a channel multiplier is ported: the SSD
    extras, ``tests/test_torch_det_layers.py``)."""
    for mod in (tnn.QConvBNAct(8, 8, 1, padding=1),
                tnn.QConvBNAct(16, 16, 3, padding=2, dilation=2, groups=4)):
        tree = unflatten_variables({k: (np.full(v.shape, -1.0 if k.endswith("min_val") else 1.0,
                                                np.float32) if k.startswith("quant/")
                                        else v.detach().numpy())
                                    for k, v in model_variables(mod).items()})
        from_jax_variables(mod, tree)
        with pytest.raises(ValueError, match="not part of the INT8 port"):
            mod.prepare_int8(QParams(0.02, 10), "cpu")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

# (name, block, cin, features, stride, groups, base_width)
BLOCKS = [("basic_s2_downsample", "BasicBlock", 32, 64, 2, 1, 64),
          ("basic_s1", "BasicBlock", 64, 64, 1, 1, 64),
          ("bottleneck_s2_downsample", "Bottleneck", 64, 32, 2, 1, 64),
          ("bottleneck_grouped_s1_downsample", "Bottleneck", 64, 32, 1, 8, 8)]


def _block_tree(port, rng):
    flat = {}
    for k, v in sorted(model_variables(port).items()):
        shape, leaf = tuple(v.shape), k.rsplit("/", 1)[1]
        if leaf == "kernel":
            flat[k] = (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))).astype(np.float32)
        elif leaf == "scale":
            flat[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf == "bias_bn":
            flat[k] = rng.normal(0.2, 0.3, shape).astype(np.float32)
        elif leaf == "mean":
            flat[k] = rng.normal(0, 0.1, shape).astype(np.float32)
        elif leaf == "var":
            flat[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            flat[k] = v.detach().numpy().copy()
    return unflatten_variables(flat)


@pytest.mark.parametrize("cfg", BLOCKS, ids=lambda c: c[0])
def test_block_int8_codes_bit_equal(cfg):
    name, kind, cin, feats, stride, groups, bw = cfg
    rng = np.random.RandomState(len(name))
    jmod = getattr(jres, kind)(features=feats, strides=stride, groups=groups, base_width=bw)
    port = getattr(tres, kind)(cin, feats, strides=stride, groups=groups, base_width=bw)
    assert hasattr(port, "downsample") == ("downsample" in name)
    q = rng.randint(0, 256, (2, 10, 10, cin)).astype(np.uint8)
    grid = (0.027, 97)
    xf = ((q.astype(np.float32) - grid[1]) * np.float32(grid[0])).astype(np.float32)
    tree = _calibrated(jmod, _block_tree(port, rng), xf)
    # the block's input codes are a jit argument: an identity join reads them
    # from memory
    _int8_equal(jmod, port, tree, q, grid, prepare_kw={"input_loaded": True})


def test_first_basic_block_contracts_the_pooled_identity():
    """A max pool and a BasicBlock jitted together, as ``freeze`` runs the
    first block: the port freezes that block's join with its identity loaded
    (``ResNet.prepare_int8``: the second product contracted) and matches
    JAX. (Few grids make the roundings differ at all; the add test above,
    on every code pair, is the one that tells them apart.)"""
    rng = np.random.RandomState(12)
    jmod, port = jres.BasicBlock(features=64), tres.BasicBlock(64, 64)
    q = rng.randint(0, 256, (8, 64, 64, 64)).astype(np.uint8)
    grid = (np.float32(0.027), 97)
    xf = ((q[:2, :20, :20].astype(np.float32) - grid[1]) * grid[0]).astype(np.float32)
    tree = _calibrated(jmod, _block_tree(port, rng), xf)

    def fn(qq):
        x = jax_max_pool(jres._pad1(JQTensor(qq, grid[0], np.int32(grid[1]))), 3, 2, "VALID")
        return jmod.apply(jax_variables(tree), x, mode=jnn.INT8).q

    want = np.asarray(jax.jit(fn)(jnp.asarray(q)))
    from_jax_variables(port, tree)
    port.eval()
    g = QParams(float(grid[0]), grid[1])
    x = tnn.max_pool(QTensor(torch.as_tensor(q), *g.tensors("cpu")), 3, 2, padding=1,
                     zero_point=grid[1])
    port.prepare_int8(g, "cpu", input_loaded=True)
    assert port.add_relu._contract == 1
    np.testing.assert_array_equal(port(x, mode=tnn.INT8).q.numpy(), want)


def _loaded_add_operands(hlo: str):
    """``{(block, operand)}``: the residual sums of the optimized HLO whose
    operand codes a fusion reads from memory (a u8 parameter) rather than
    making them (a u8 convert inside the fusion)."""
    loaded = set()
    for body in hlo.split("\n\n"):
        defs = {}
        for line in body.splitlines():
            m = re.match(r"\s*(?:ROOT )?%([\w.\-]+) = (\S+) ([\w\-]+)\((.*?)\)", line)
            if m:
                defs[m.group(1)] = (m.group(2), m.group(3),
                                    [a.strip().lstrip("%") for a in m.group(4).split(",")], line)

        def origin(name, depth=0):
            if name not in defs or depth > 6:
                return None
            ty, op, args, _ = defs[name]
            if op == "parameter":
                return "loaded" if ty.startswith("u8") else None
            if op == "convert" and ty.startswith("u8"):
                return "made"
            return next((o for o in (origin(a, depth + 1) for a in args) if o), None)

        for ty, op, args, line in defs.values():
            block = re.search(r"ResNet/(layer\d_\d+)/\w*add_relu/add", line)
            if op != "add" or not block or not all(defs.get(a, ("", ""))[1] == "multiply"
                                                   for a in args[:2]):
                continue
            for i, a in enumerate(args[:2]):
                if origin(a) == "loaded":
                    loaded.add((block.group(1), i))
    return loaded


@pytest.mark.parametrize("kind", ["BasicBlock", "Bottleneck"])
def test_frozen_graph_loads_only_the_pooled_identity(kind):
    """What ``ResNet.prepare_int8`` encodes, read from XLA's optimized HLO of
    the frozen model (``layers=(2, 1, 1, 1)``, 32x32, batch 2; the same holds
    for the full qresnet18, qresnet34 and qresnet50 at 224x224, batch 8):
    every residual sum makes both operands' codes in its fusion, except the
    BasicBlock ``layer1_0``'s, whose identity (the second operand) is the
    max pool's output, loaded."""
    model = jres.ResNet(block=getattr(jres, kind), layers=(2, 1, 1, 1), num_classes=CLASSES)
    x = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        key = getattr(path[-1], "name", getattr(path[-1], "key", ""))
        if key in ("min_val", "max_val"):
            return jnp.full(leaf.shape, rng.uniform(0.5, 3) * (1 if key == "max_val" else -1),
                            jnp.float32)
        if key in ("scale", "var"):
            return jnp.ones(leaf.shape, jnp.float32)
        return jnp.asarray(rng.randn(*leaf.shape).astype(np.float32) * 0.1)

    v = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(model.init, jax.random.PRNGKey(0), x))
    hlo = jax.jit(lambda xx: model.apply(v, xx, mode=jnn.INT8)).lower(x).compile().as_text()
    basic = kind == "BasicBlock"
    assert _loaded_add_operands(hlo) == ({("layer1_0", 1)} if basic else set())
    port = tres.ResNet(block=getattr(tres, kind), layers=(2, 1, 1, 1), num_classes=CLASSES)
    from_jax_variables(port, unflatten_variables(flatten_variables(jax.tree.map(np.asarray, v))))
    port.prepare_int8("cpu", SIZE)
    contract = {n: m._contract for n, m in port.named_modules() if isinstance(m, tnn.QAddReLU)}
    want = dict.fromkeys(contract)
    if basic:
        want["layer1_0.add_relu"] = 1
    assert len(contract) == 5 and contract == want


# ---------------------------------------------------------------------------
# Small whole models
# ---------------------------------------------------------------------------

# (block, groups, width_per_group, backend)
SMALL = [("BasicBlock", 1, 64, "qnnpack"), ("BasicBlock", 1, 64, "fbgemm"),
         ("Bottleneck", 1, 64, "qnnpack"), ("Bottleneck", 1, 64, "fbgemm"),
         ("Bottleneck", 4, 16, "qnnpack"), ("Bottleneck", 4, 16, "fbgemm")]
SIZE = 32


def _small_pair(kind, groups, wpg, backend, quantized=True):
    kw = dict(groups=groups, width_per_group=wpg) if groups > 1 else {}
    jm = jres.ResNet(block=getattr(jres, kind), layers=(1, 1, 1, 1), num_classes=CLASSES,
                     quantized=quantized, qconfig=jq.get_qconfig(backend), **kw)
    tm = tres.ResNet(block=getattr(tres, kind), layers=(1, 1, 1, 1), num_classes=CLASSES,
                     quantized=quantized, qconfig=get_qconfig(backend), **kw)
    return jm, tm


@pytest.mark.parametrize("case", SMALL, ids=lambda c: f"{c[0]}-g{c[1]}-{c[3]}")
def test_small_model_export_and_int8_layers_bit_equal(case, tmp_path):
    """Random init and two QAT calibration forwards in JAX (train mode: the
    BN statistics move too); the port's ``export_int8`` of those variables
    equals JAX's array for array, and the port serving it gives the frozen
    JAX graph's codes at every top-level layer, the pooled codes and the
    logits, bit for bit."""
    from chip_smoke import layer_codes
    from test_torch_mobilenet_fixture import jax_reference_codes

    kind, groups, wpg, backend = case
    jm, tm = _small_pair(kind, groups, wpg, backend)
    rng = np.random.RandomState(0)
    images = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(images))
    calibrate = jax.jit(lambda vv, xb: jm.apply(vv, xb, mode=jnn.QAT, train=True,
                                                mutable=["batch_stats", "quant"]))
    for _ in range(2):
        _, upd = calibrate(v, jnp.asarray(rng.randn(2, SIZE, SIZE, 3).astype(np.float32)))
        v = {**v, **upd}
    tree = unflatten_variables(flatten_variables(jax.tree.map(np.asarray, v)))
    from_jax_variables(tm, tree)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    export_int8(tm, mine)
    jq.export_int8(v, theirs, qconfig=jq.get_qconfig(backend))
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want, jcodes = jax_reference_codes(jm, jq.load_int8(theirs), jnp.asarray(images))
    served = _small_pair(kind, groups, wpg, backend)[1]
    from_jax_variables(served, load_int8(mine))

    class Pred:  # what chip_smoke.layer_codes reads of an Int8Predictor
        def __init__(self):
            self.model, self.fn = served, freeze(served, "cpu", SIZE)

        def __call__(self, x):
            return self.fn(x)

    logits, codes = layer_codes(Pred(), images)
    assert sorted(codes) == sorted(jcodes) and "pool" in codes and "layer4_0" in codes
    for k, c in jcodes.items():
        np.testing.assert_array_equal(codes[k].numpy(), c, err_msg=k)
        assert len(np.unique(c)) >= 8, k
    np.testing.assert_array_equal(logits.numpy(), want)
    routes = {m._route for m in served.modules() if isinstance(m, tnn.QConvBNAct)}
    assert routes == {"im2col", "matmul", "grouped" if groups > 1 else "dense3x3"}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

TRAIN_BATCH = 8


@pytest.fixture(scope="module")
def train_runs():
    jm, tm = _small_pair("BasicBlock", 1, 64, "qnnpack")
    from frostnet_tpu_torch.quant import numpy_init

    tree = numpy_init(tm, 0)
    batches = [train_batch(k, TRAIN_BATCH, SIZE, CLASSES) for k in range(3)]
    tx = jax_optimizer("QSGD", 1e-3, weight_decay=jax_gwd(4e-5), noise_decay=1.0)
    js = jax_train_state(jm, tree, tx)
    jmetrics, jflats = [], []
    for k, mode in enumerate((jnn.FP32, jnn.QAT)):
        if k == 1:
            js = js.start_qat()
        js, m = jax_train_step(jm, mode, num_classes=CLASSES, donate=False)(js, batches[k])
        jmetrics.append(jax.tree.map(float, m))
        jflats.append(flatten_variables(jax.tree.map(np.asarray, js.model_variables)))
    jmetrics.append(jax.tree.map(float, jax_eval_step(jm, jnn.QAT_FROZEN, CLASSES)(js, batches[2])))
    tx = get_optimizer("QSGD", 1e-3, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(tm, tx, seed=0, device="cpu", variables=tree)
    metrics, flats = [], []
    for k, mode in enumerate((tnn.FP32, tnn.QAT)):
        if k == 1:
            state.start_qat()
        m = make_train_step(mode, num_classes=CLASSES)(state, batches[k])
        metrics.append({n: float(v) for n, v in m.items()})
        flats.append({n: v.detach().numpy().copy() for n, v in model_variables(tm).items()})
    metrics.append({n: float(v) for n, v in
                    make_eval_step(tnn.QAT_FROZEN, CLASSES)(state, batches[2]).items()})
    return dict(metrics=metrics, jax_metrics=jmetrics, flats=flats, jax_flats=jflats)


def test_train_losses_within_bands(train_runs):
    """The losses of the FP32 step (``FP32_LOSS_REL``), of the QAT step and
    of the QAT_FROZEN eval step (``QAT_LOSS_REL``) against JAX's."""
    (fp32, qat, ev), (jfp32, jqat, jev) = train_runs["metrics"], train_runs["jax_metrics"]
    assert abs(fp32["loss"] - jfp32["loss"]) <= FP32_LOSS_REL * jfp32["loss"], (fp32, jfp32)
    assert fp32["top1"] == jfp32["top1"]
    for got, want in ((qat, jqat), (ev, jev)):
        assert abs(got["loss"] - want["loss"]) <= QAT_LOSS_REL * want["loss"], (got, want)


def test_train_observers_and_bn_within_bands(train_runs):
    """Every observer (the add_relu sites among them) steps in the QAT step
    and not in the FP32 one; after it, the observers within 3% of their
    range in the median; the FP32 step's BN statistics within 1e-4 of a
    std."""
    (after_fp32, after_qat), (jfp32, jqat) = train_runs["flats"], train_runs["jax_flats"]
    obs = [k for k in after_qat if k.startswith("quant/") and k.endswith(".min_val")]
    assert len(obs) == 1 + 2 * 12 + 4 + 2  # stub, 12 convs, 4 add_relu, fc
    assert sum("/add_relu/" in k for k in obs) == 4
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


@pytest.mark.parametrize("kind", ["BasicBlock", "Bottleneck"])
def test_float_model_forward_and_train_step(kind):
    """The float ResNets (no observers, a float add and ReLU): the FP32 eval
    forward within ``FLOAT_REL``, the loss of one SGD step within
    ``TRAIN_LOSS_REL`` and its update within ``UPDATE_REL``; INT8 mode runs
    float, as JAX's does."""
    from frostnet_tpu_torch.quant import numpy_init

    jm, tm = _small_pair(kind, 1, 64, "qnnpack", quantized=False)
    tree = numpy_init(tm, 1)
    assert "quant" not in tree or not tree["quant"]
    x = np.random.RandomState(5).randn(4, SIZE, SIZE, 3).astype(np.float32)
    jy = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, mode=jnn.FP32))(
        jax_variables(tree), jnp.asarray(x)))
    from_jax_variables(tm, tree)
    with torch.no_grad():
        ty = tm(torch.as_tensor(x), mode=tnn.FP32).numpy()
    assert np.abs(ty - jy).max() <= FLOAT_REL * np.abs(jy).max()
    batch = train_batch(0, 4, SIZE, CLASSES)
    js, jmet = jax_train_step(jm, jnn.FP32, num_classes=CLASSES, donate=False)(
        jax_train_state(jm, tree, jax_optimizer("SGD", 1e-2)), batch)
    port = _small_pair(kind, 1, 64, "qnnpack", quantized=False)[1]
    state = create_train_state(port, get_optimizer("SGD", 1e-2), device="cpu", variables=tree)
    m = make_train_step(tnn.FP32, num_classes=CLASSES)(state, batch)
    assert abs(float(m["loss"]) - float(jmet["loss"])) <= TRAIN_LOSS_REL * abs(float(jmet["loss"]))
    jflat = flatten_variables(jax.tree.map(np.asarray, js.model_variables))
    init = flatten_variables(tree)
    mine = {k: v.detach().numpy() for k, v in model_variables(port).items()}
    params = [k for k in init if k.startswith("params/")]
    d_jax = np.concatenate([(jflat[k] - init[k]).ravel() for k in params])
    d_port = np.concatenate([(mine[k] - init[k]).ravel() for k in params])
    assert np.linalg.norm(d_port - d_jax) <= UPDATE_REL * np.linalg.norm(d_jax)
    tm.prepare_int8("cpu", SIZE)
    with torch.no_grad():
        np.testing.assert_array_equal(tm(torch.as_tensor(x), mode=tnn.INT8).numpy(), ty)


# ---------------------------------------------------------------------------
# Registry, weight decay, the user's path
# ---------------------------------------------------------------------------

def _jax_shapes(model):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        key = (f"quant/{'/'.join(names[1:-1])}.{names[-1]}" if names[0] == "quant"
               else "/".join(names))
        out[key] = tuple(leaf.shape)
    return out


def test_registry_has_the_twelve_names():
    assert [n for n in list_models() if "resne" in n] == sorted(NAMES)
    m = create_model("qresnet50")
    assert m.num_classes == 1000 and m.quantized and isinstance(m.layer1_0, tres.Bottleneck)
    assert not create_model("resnet18").quantized
    with pytest.raises(ValueError, match="FrostNet-only"):
        create_model("qresnet18", fuse_int8=True)


@pytest.mark.parametrize("name", ["qresnet18", "resnet34", "qresnet50", "resnext101_32x8d"])
def test_variables_match_jax(name):
    """Every variable of the JAX model, by name and shape, and no other."""
    port = create_model(name, num_classes=CLASSES)
    mine = {k: tuple(v.shape) for k, v in model_variables(port).items()}
    assert mine == _jax_shapes(jax_create_model(name, num_classes=CLASSES))


def test_grouped_weight_decay_groups_as_jax():
    """Each parameter of a grouped ResNet's variables decays by JAX's
    ``grouped_weight_decay`` factor: conv kernels (grouped ones too) fully,
    the ``fc``'s ``(in, out, 1, 1)`` kernel by 0, BN and biases by the
    BN share."""
    _, tm = _small_pair("Bottleneck", 4, 16, "qnnpack")
    from frostnet_tpu_torch.quant import numpy_init

    tree = numpy_init(tm, 2)
    params = jax_variables(tree)["params"]
    zeros = jax.tree.map(jnp.zeros_like, params)
    upd, _ = jax_gwd(4e-5).update(zeros, jax_gwd(4e-5).init(params), params)
    want = flatten_variables({"params": jax.tree.map(np.asarray, upd)})
    from_jax_variables(tm, tree)
    rule = grouped_weight_decay(4e-5)
    named = dict(model_variables(tm))
    groups = set()
    for k, w in want.items():
        p = named[k].detach()
        got = (np.float32(rule(p)) * p.numpy()).astype(np.float32)
        np.testing.assert_array_equal(got, w, err_msg=k)
        groups.add(rule(p))
    assert groups == {0.0, 4e-5, 4e-5 * 0.01}


def test_trainer_evaluator_and_serve_on_cpu(tmp_path):
    """``classification.main`` on ``qresnet18`` (full depth, 32x32, 10
    classes, one FP32 and one QAT epoch of one step), ``evaluate.main
    --export_int8`` on ``best/``, then ``serve.main`` on the artifact: its
    logits equal the in-process freeze of the evaluator's model bit for
    bit."""
    from frostnet_tpu_torch import serve
    from frostnet_tpu_torch.train import classification, evaluate

    name = "qresnet18"
    cfg = classification.ClassificationConfig(
        model=name, num_classes=CLASSES, image_size=32, batch_size=4, steps_per_epoch=1,
        fp_epochs=1, epochs=1, learning_rate=1e-3, log_every=1, device="cpu",
        save_dir=str(tmp_path / "run"))
    _, res = classification.main(cfg)
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert np.isfinite(res["qat"]["loss"]) and np.isfinite(res["int8"]["loss"])
    artifact = str(tmp_path / "int8.npz")
    ev = evaluate.main(evaluate.build_parser([]).parse_args(
        ["--model", name, "--checkpoint", str(tmp_path / "run" / "best"), "--num_classes",
         str(CLASSES), "--image_size", "32", "--batch_size", "4", "--calib_batches", "1",
         "--export_int8", artifact, "--device", "cpu"]))
    assert np.isfinite(ev["int8"]["loss"]) and ev["export_bytes"] == os.path.getsize(artifact)
    direct = create_model(name, num_classes=CLASSES)
    direct.load_state_dict(ev["state"].model.state_dict())
    images = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    want = freeze(direct, "cpu", 32)(images).numpy()
    logits = str(tmp_path / "logits.npy")
    serve.main(serve.build_parser().parse_args(
        ["--model", name, "--artifact", artifact, "--num_classes", str(CLASSES),
         "--image_size", "32", "--batch_size", "2", "--iters", "1", "--device", "cpu",
         "--save_logits", logits]))
    np.testing.assert_array_equal(np.load(logits), want)
