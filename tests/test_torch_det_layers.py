"""The detection layers of the PyTorch port against the JAX package.

* The depthwise conv with a channel multiplier (the SSD extras' 3x3, 32 ->
  128 channels, stride 2; and a multiplier of 2 at stride 1 with ReLU): INT8
  codes bit-equal to the frozen JAX conv on the depthwise route, qnnpack and
  fbgemm (whose per-channel weight observer sees every output channel); the
  float phases in the bands of ``tests/test_torch_blocks.py``; the HWIO
  kernel (3, 3, 1, 128) runs as torch's grouped OIHW weight in JAX's
  group-major channel order.
* ``_relu_q`` on a QTensor (``max(q, zp)``), ``_maxpool_ceil`` (codes and
  floats, every odd and even size of the nets) and the Tiny-DSOD crop.
* ``avg_pool`` at k = 3 (the SSD extras' last pool): the multiply by
  ``f32(1/9)`` and the division agree at every window sum; codes bit-equal
  to the frozen JAX pool around every half-way point.
* The ``requant_up{i}`` joins: ``resize_bilinear(align_corners=False)`` at
  Tiny-DSOD's sizes 2->3, 3->5, 5->10, 10->19, 19->38 bit-equal to the JAX
  function (no output side a multiple of 64: each product rounds, then the
  sum), and the QuantStub after it.
* The ``qadd{i}`` joins: which operand each fusion loads, read from the
  frozen Tiny-DSOD's optimized HLO (only ``qadd5``'s second, ``infeat_1``),
  is what ``TDSODFeat.prepare_int8`` encodes; and a small Tiny-DSOD (96x96)
  frozen whole is bit-equal to the frozen JAX graph at every layer and
  source.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu.detection import models as jdm, tdsod as jtd
from frostnet_tpu.nn import pool as jpool
from frostnet_tpu.ops.resize import resize_bilinear as jresize
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.detection import models as tdm, tdsod as ttd
from frostnet_tpu_torch.ops.resize import resize_bilinear
from frostnet_tpu_torch.quant import ObserverState, QTensor, get_qconfig
from frostnet_tpu_torch.quant.export import flatten_variables, from_jax_variables
from test_torch_blocks import (FLIP_FRACTION, MODES, REL_FLOAT, _block_input, _block_tree,
                               _calibrate_jax, _int8_compare, _jax_float, _port_float)

pytestmark = pytest.mark.usefixtures("few_threads")

# (name, cin, cout, stride, act, backend)
MULT_CONVS = [("extra_32to128_s2", 32, 128, 2, None, "qnnpack"),
              ("extra_32to128_s2_fbgemm", 32, 128, 2, None, "fbgemm"),
              ("mult2_s1_relu", 16, 32, 1, "relu", "qnnpack")]


def _mult_pair(cfg):
    _, cin, cout, s, act, backend = cfg
    jmod = jnn.QConvBNAct(cout, 3, strides=s, padding=1, groups=cin, act=act,
                          qconfig=jq.get_qconfig(backend))
    port = tnn.QConvBNAct(cin, cout, 3, strides=s, padding=1, groups=cin, act=act,
                          qconfig=get_qconfig(backend))
    return jmod, port


@pytest.mark.parametrize("cfg", MULT_CONVS, ids=lambda c: c[0])
def test_channel_multiplier_int8_codes_bit_equal(cfg):
    jmod, port = _mult_pair(cfg)
    q, grid, xf = _block_input(cfg[1], 101, size=19)
    tree = _calibrate_jax(jmod, _block_tree(port, 102), xf, {"train": False})
    flips, worst, _ = _int8_compare(jmod, port, tree, q, grid, {"train": False})
    assert port._route == "depthwise" and port._taps.shape == (9, cfg[2])
    assert flips == 0, (flips, worst)
    per_channel = cfg[5] == "fbgemm"
    assert tuple(port.w_obs.min_val.shape) == ((cfg[2],) if per_channel else ())


@pytest.mark.parametrize("phase,train", [("FP32", True), ("QAT", True), ("QAT", False),
                                         ("QAT_FROZEN", False)])
def test_channel_multiplier_float_phases_within_bands(phase, train):
    jmod, port = _mult_pair(MULT_CONVS[0])
    _, _, xf = _block_input(32, 111, size=19)
    tree = _calibrate_jax(jmod, _block_tree(port, 112), xf, {"train": False})
    jmode, tmode = MODES[phase]
    jy, upd, grads, w = _jax_float(tree, xf, jmod, jmode, train=train)
    ty, state, tgrads = _port_float(port, tree, xf, tmode, w, train=train)
    assert ty.shape == jy.shape == (2, 10, 10, 128)
    span = float(jy.max() - jy.min())
    assert (np.abs(ty - jy) > REL_FLOAT * span).mean() <= FLIP_FRACTION
    g_j = np.asarray(grads["kernel"])
    assert np.abs(tgrads["kernel"] - g_j).max() <= 1e-3 * np.abs(g_j).max() + 1e-6
    jflat = flatten_variables({"batch_stats": jax.tree.map(np.asarray, upd.get("batch_stats", {})),
                               "quant": jax.tree.map(np.asarray, upd.get("quant", {}))})
    for k, v in jflat.items():
        assert np.max(np.abs(state[k] - v)) <= 0.05 * (float(np.max(np.abs(v))) + 1e-6), k


def test_channel_multiplier_group_major_order():
    """Output channel ``oc`` reads input channel ``oc // m`` in both: a
    one-hot input channel lights exactly its ``m`` outputs."""
    port = tnn.QConvBNAct(8, 32, 3, padding=1, groups=8, act=None, use_bn=False,
                          quantized=False)
    with torch.no_grad():
        port.kernel.fill_(1.0)
    x = torch.zeros(1, 5, 5, 8)
    x[..., 3] = 1.0
    y = port(x)
    lit = (y.abs().sum(dim=(0, 1, 2)) > 0).nonzero().flatten().tolist()
    assert lit == [12, 13, 14, 15]
    jmod = jnn.QConvBNAct(32, 3, padding=1, groups=8, act=None, use_bn=False, quantized=False)
    v = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 8)))
    v = jax.tree.map(jnp.ones_like, v)
    jy = np.asarray(jmod.apply(v, jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(y.detach().numpy(), jy)


def test_relu_q_on_codes():
    rng = np.random.RandomState(3)
    q = rng.randint(0, 256, (2, 5, 5, 16)).astype(np.uint8)
    want = jdm._relu_q(JQTensor(jnp.asarray(q), jnp.float32(0.05), jnp.int32(131)))
    got = tdm._relu_q(QTensor(torch.as_tensor(q), torch.tensor(0.05), torch.tensor(131,
                                                                                   dtype=torch.int32)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    x = rng.randn(2, 5, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(tdm._relu_q(torch.as_tensor(x)).numpy(),
                                  np.asarray(jdm._relu_q(jnp.asarray(x))))


@pytest.mark.parametrize("size", [75, 38, 19, 10, 5, 3, 2, 1])
def test_maxpool_ceil(size):
    rng = np.random.RandomState(size)
    q = rng.randint(0, 256, (2, size, size, 8)).astype(np.uint8)
    want = jax.jit(lambda qq: jtd._maxpool_ceil(JQTensor(qq, jnp.float32(0.1),
                                                         jnp.int32(5))).q)(jnp.asarray(q))
    got = ttd._maxpool_ceil(QTensor(torch.as_tensor(q), torch.tensor(0.1), torch.tensor(5)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want))
    assert got.q.shape[1] == -(-size // 2)
    x = rng.randn(2, size, size, 8).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    yt = ttd._maxpool_ceil(xt)
    np.testing.assert_array_equal(yt.detach().numpy(),
                                  np.asarray(jax.jit(jtd._maxpool_ceil)(jnp.asarray(x))))
    w = rng.randn(*yt.shape).astype(np.float32)
    (yt * torch.as_tensor(w)).sum().backward()
    gj = jax.grad(lambda xx: jnp.sum(jtd._maxpool_ceil(xx) * w))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))


def test_crop_keeps_the_grid():
    q = np.arange(2 * 20 * 20 * 3, dtype=np.int64).reshape(2, 20, 20, 3).astype(np.uint8)
    t = QTensor(torch.as_tensor(q), torch.tensor(0.3), torch.tensor(7))
    c = ttd._crop(t, 19, 19)
    np.testing.assert_array_equal(c.q.numpy(), q[:, :19, :19])
    assert c.scale is t.scale and c.zero_point is t.zero_point


def test_avg_pool_k3_forms_and_codes():
    s = torch.arange(0, 255 * 9 + 1, dtype=torch.float32)
    assert torch.equal(torch.round(s * (torch.tensor(1.0) / torch.tensor(9.0))),
                       torch.round(s / torch.tensor(9.0)))
    rng = np.random.RandomState(9)
    q = rng.randint(0, 256, (4, 3, 3, 128)).astype(np.uint8)
    q[0, :, :, :9] = np.arange(9 * 9).reshape(1, 3, 3, 9) % 256  # sums around half points
    want = jax.jit(lambda qq: jpool.avg_pool(JQTensor(qq, jnp.float32(0.1), jnp.int32(3)),
                                             3, 3).q)(jnp.asarray(q))
    got = tnn.avg_pool(QTensor(torch.as_tensor(q), torch.tensor(0.1), torch.tensor(3)), 3, 3)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_in,n_out", [(2, 3), (3, 5), (5, 10), (10, 19), (19, 38)])
def test_requant_up_resize_and_stub(n_in, n_out):
    """The resize bit-equal to JAX's, and the QuantStub's codes on it."""
    rng = np.random.RandomState(n_out)
    x = (rng.randn(2, n_in, n_in, 128) * 2).astype(np.float32)
    want = np.asarray(jax.jit(lambda xx: jresize(xx, (n_out, n_out), align_corners=False))(
        jnp.asarray(x)))
    got = resize_bilinear(torch.as_tensor(x), (n_out, n_out), align_corners=False).numpy()
    np.testing.assert_array_equal(got, want)
    stub = jnn.QuantStub()
    obs = {"quant": {"act": ObserverState(np.float32(-4.0), np.float32(5.0))}}
    v = jax_variables(obs)
    jcodes = jax.jit(lambda xx: stub.apply(v, jresize(xx, (n_out, n_out), align_corners=False),
                                           mode=jnn.INT8).q)(jnp.asarray(x))
    port = tnn.QuantStub()
    from_jax_variables(port, obs)
    port.prepare_int8("cpu")
    tcodes = port(torch.as_tensor(got), mode=tnn.INT8).q
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))


def _loaded_add_operands(hlo: str, pattern: str):
    """``{(join, operand)}``: the sums of the optimized HLO whose operand
    codes a fusion reads from memory (a u8 parameter) rather than makes (a
    u8 convert inside the fusion); ``pattern`` names the join from the op's
    metadata."""
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
            join = re.search(pattern, line)
            if op != "add" or not join or not all(defs.get(a, ("", ""))[1] == "multiply"
                                                 for a in args[:2]):
                continue
            for i, a in enumerate(args[:2]):
                if origin(a) == "loaded":
                    loaded.add((join.group(1), i))
    return loaded


SMALL = 96


@pytest.fixture(scope="module")
def small_tdsod():
    """A Tiny-DSOD at 96x96: seeded variables, calibrated by two JAX QAT
    forwards; (JAX module, variables, images)."""
    jmod = jtd.TDSODFeat()
    port = ttd.TDSODFeat()
    tree = _block_tree(port, 121)
    rng = np.random.RandomState(122)
    xf = rng.randn(2, SMALL, SMALL, 3).astype(np.float32)
    tree = _calibrate_jax(jmod, tree, xf, {"train": False})
    images = rng.randn(2, SMALL, SMALL, 3).astype(np.float32)
    return jmod, tree, images


def test_qadd_loaded_operands_from_the_frozen_graph(small_tdsod):
    """Only ``qadd5`` loads an operand, its second (``infeat_1``, the
    ceil-mode pool's output); the same holds at 300x300. The port's
    ``prepare_int8`` contracts exactly that product."""
    jmod, tree, images = small_tdsod
    v = jax_variables(tree)
    hlo = jax.jit(lambda x: jmod.apply(v, x, mode=jnn.INT8)).lower(
        jnp.asarray(images)).compile().as_text()
    assert _loaded_add_operands(hlo, r"TDSODFeat/(qadd\d)/add\"") == {("qadd5", 1)}
    port = from_jax_variables(ttd.TDSODFeat(), tree)
    port.eval()
    port.prepare_int8("cpu")
    contract = {f"qadd{i}": getattr(port, f"qadd{i}")._contract for i in range(1, 6)}
    assert contract == {"qadd1": None, "qadd2": None, "qadd3": None, "qadd4": None, "qadd5": 1}
    assert {(f"qadd{k}", i) for k, i in ttd.QADD_LOADED.items()} == {("qadd5", 1)}


def test_small_tdsod_int8_bit_equal(small_tdsod):
    """Every top-level layer's codes and the six sources of the frozen port
    equal the frozen JAX graph's at 96x96."""
    from test_torch_det_fixture import jax_det_codes

    jmod, tree, images = small_tdsod
    jsrc, jcodes = jax_det_codes(jmod, jax_variables(tree), jnp.asarray(images))
    port = from_jax_variables(ttd.TDSODFeat(), tree)
    port.eval()
    port.prepare_int8("cpu")
    codes, hooks = {}, []
    for name, mod in port.named_children():
        hooks.append(mod.register_forward_hook(
            lambda m, a, out, name=name: codes.__setitem__(name, out.q)
            if isinstance(out, QTensor) else None))
    with torch.no_grad():
        src = port(torch.as_tensor(images), mode=tnn.INT8)
    assert set(codes) == set(jcodes) and len(codes) > 60
    for k in jcodes:
        np.testing.assert_array_equal(codes[k].numpy(), jcodes[k], err_msg=k)
    for a, b in zip(src, jsrc):
        np.testing.assert_array_equal(a.numpy(), b)
