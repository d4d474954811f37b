"""PyTorch port, FrostNet as a dilated feature backbone, against JAX.

``frostnet_small_0_35`` at 32x32, calibrated in JAX (random init and two QAT
forwards at output stride 32; the variables do not depend on the stride):

* ``output_stride`` 32, 16 and 8: the four features' shapes equal JAX's;
  FP32 within ``FP32_TOL`` of the largest value (float32 convs summed in
  another order); INT8, fused and unfused, bit for bit equal to JAX
  ``freeze()`` (the dequantized codes), the dilated blocks on the unfused
  route;
* ``frozen_stages``: the gradients of every parameter equal JAX's
  ``stop_gradient`` semantics within ``GRAD_TOL`` (relative to each
  parameter's largest gradient);
* the torch-checkpoint loader: a reference-layout state dict built here goes
  through JAX's loader then ``from_jax_variables``, and through the port's;
  every variable is identical, and a checkpoint with no match raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401 - a fixture
from frostnet_tpu import nn as jnn
from frostnet_tpu.models import create_model as jax_create_model
from frostnet_tpu.models.frostnet_features import FrostNetFeatures as JaxFeatures
from frostnet_tpu.models.frostnet_features import (
    load_torch_frostnet_checkpoint as jax_load_checkpoint)
from frostnet_tpu.quant import freeze as jax_freeze
from frostnet_tpu_torch.models import (CascadePreExBottleneck, FrostNetFeatures, create_model,
                                       load_torch_frostnet_checkpoint)
from frostnet_tpu_torch.nn import FP32
from frostnet_tpu_torch.quant import freeze, from_jax_variables, model_variables

SIZE, BATCH = 32, 2
FP32_TOL = 1e-4    # of the largest |feature|: float32 convs in another summation order
GRAD_TOL = 1e-4    # of each parameter's largest |gradient|
STRIDES = (32, 16, 8)
# stage 3 keeps its stride at 8 too: the JAX trunk dilates only stages 4 and 5
FEATURE_HW = {32: (8, 4, 2, 1), 16: (8, 4, 2, 2), 8: (8, 4, 2, 2)}


@pytest.fixture(scope="module")
def jax_reference():
    """Calibrated variables, the images, and per stride JAX's FP32 and
    frozen INT8 features."""
    rng = np.random.RandomState(0)
    images = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    model = JaxFeatures(mode="small", width_mult=0.35, quantized=True)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(model.init)(key, jnp.asarray(images))
    calibrate = jax.jit(lambda v, xb: model.apply(v, xb, mode=jnn.QAT, train=True,
                                                  mutable=["batch_stats", "quant"]))
    for _ in range(2):
        _, updates = calibrate(variables, jnp.asarray(rng.randn(*images.shape)
                                                      .astype(np.float32)))
        variables = {**variables, **updates}
    feats = {}
    for os_ in STRIDES:
        m = JaxFeatures(mode="small", width_mult=0.35, quantized=True, output_stride=os_)
        fp32 = jax.jit(lambda x, m=m: m.apply(variables, x, mode=jnn.FP32))(images)
        int8 = jax_freeze(m, variables)(jnp.asarray(images))
        feats[os_] = ([np.asarray(f) for f in fp32], [np.asarray(f) for f in int8])
    return variables, images, feats


def _port(variables, os_, fuse=False, frozen_stages=-1):
    m = FrostNetFeatures(mode="small", width_mult=0.35, quantized=True, output_stride=os_,
                         fuse_int8=fuse, frozen_stages=frozen_stages)
    return from_jax_variables(m, jax.tree.map(np.asarray, variables))


@pytest.mark.parametrize("os_", STRIDES)
def test_features_match_jax(jax_reference, few_threads, os_):  # noqa: F811
    variables, images, feats = jax_reference
    want_fp32, want_int8 = feats[os_]
    assert [f.shape[1] for f in want_int8] == list(FEATURE_HW[os_])
    port = _port(variables, os_)
    with torch.no_grad():
        got = port(torch.as_tensor(images), FP32)
    for g, w in zip(got, want_fp32):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=FP32_TOL * np.abs(w).max())
    for fuse in (False, True):
        port = _port(variables, os_, fuse=fuse)
        got = freeze(port, "cpu", image_size=SIZE)(images)
        for g, w in zip(got, want_int8):
            np.testing.assert_array_equal(g.numpy(), w)
        fused = [b.fuse_int8 for b in port.trunk.blocks]
        assert fused == [fuse and b.dilation == 1 for b in port.trunk.blocks]
        # the fused kernel is planned for the undilated blocks only
        names = [n for n, _ in port.trunk.block_specs(SIZE)]
        assert names == [n for n, b in port.trunk.named_children()
                         if isinstance(b, CascadePreExBottleneck) and b.dilation == 1]


def test_dilated_stages_and_parameter_tree():
    for os_, d4, d5 in ((32, 1, 1), (16, 2, 2), (8, 2, 4)):
        net = create_model("frostnet_quant_large_1_0", output_stride=os_)
        assert {b.dilation for b in net.blocks[12:17]} == {d4}
        assert net.layer5_0.dilation == d5 and net.layer5_0.conv2.padding == 2 * d5
        if os_ < 32:
            assert all(b.strides == 1 for b in net.blocks[12:])
        # the variables do not depend on the stride
        assert {k: tuple(v.shape) for k, v in model_variables(net).items()} == {
            k: tuple(v.shape) for k, v in model_variables(
                create_model("frostnet_quant_large_1_0")).items()}
    assert len(create_model("frostnet_quant_large_1_0", output_stride=16).block_specs(224)) == 12
    assert len(create_model("frostnet_quant_large_1_0", output_stride=8).block_specs(224)) == 12


def test_frozen_stages_gradients_match_jax(few_threads):  # noqa: F811
    rng = np.random.RandomState(3)
    images = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    jm = JaxFeatures(mode="small", width_mult=0.35, frozen_stages=2)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(images))
    port = FrostNetFeatures(mode="small", width_mult=0.35, frozen_stages=2)
    from_jax_variables(port, jax.tree.map(np.asarray, variables))
    feats = port(torch.as_tensor(images))
    assert [f.requires_grad for f in feats] == [False, False, True, True]
    weights = [rng.randn(*f.shape).astype(np.float32) for f in feats]

    def loss(params):
        out = jm.apply({**variables, "params": params}, images)
        return sum(jnp.sum(f * w) for f, w in zip(out, weights))

    want = _flat(jax.jit(jax.grad(loss))(variables["params"]))
    sum((f * torch.as_tensor(w)).sum() for f, w in zip(feats, weights)).backward()
    got = {k: p.grad for k, p in model_variables(port).items() if k.startswith("params/")}
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)
    # the frozen stages' parameters still learn through the later stages
    assert float(np.abs(want["params/trunk/layer1_0/conv2/kernel"]).max()) > 0


def _flat(tree, prefix="params"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _reference_state(rng, port) -> dict:
    """A state dict in the reference torch FrostNet's layout (NCHW, OIHW,
    ``<block>.conv.{0,1}``, ``classifier.2``, ``num_batches_tracked``), of
    random values, for the modules of ``port``."""
    state = {}
    for name, mod in port.named_modules():
        if not hasattr(mod, "kernel"):
            continue
        parts = name.split(".")
        if parts[0] == "classifier":
            kh, kw, ci, co = mod.kernel.shape
            state["classifier.2.weight"] = torch.as_tensor(
                rng.randn(co, ci, kh, kw).astype(np.float32))
            state["classifier.2.bias"] = torch.as_tensor(rng.randn(co).astype(np.float32))
            continue
        blk = parts[0].replace("_", ".", 1) if parts[0].startswith("layer") else parts[0]
        base = ".".join([blk] + parts[1:]) + ".conv"
        kh, kw, ci, co = mod.kernel.shape
        state[f"{base}.0.weight"] = torch.as_tensor(rng.randn(co, ci, kh, kw).astype(np.float32))
        state[f"{base}.1.weight"] = torch.as_tensor(rng.rand(co).astype(np.float32) + 0.5)
        state[f"{base}.1.bias"] = torch.as_tensor(rng.randn(co).astype(np.float32))
        state[f"{base}.1.running_mean"] = torch.as_tensor(rng.randn(co).astype(np.float32))
        state[f"{base}.1.running_var"] = torch.as_tensor(rng.rand(co).astype(np.float32) + 0.5)
        state[f"{base}.1.num_batches_tracked"] = torch.tensor(7)
    return state


def test_torch_checkpoint_loader_matches_jax(tmp_path):
    name = "frostnet_quant_small_0_35"
    jm = jax_create_model(name, num_classes=10)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree.map(lambda s: np.full(s.shape, 0.25, s.dtype), shapes)
    port = from_jax_variables(create_model(name, num_classes=10),
                              jax.tree.map(np.asarray, variables))
    rng = np.random.RandomState(5)
    ema = {f"module.{k}": v for k, v in _reference_state(rng, port).items()}
    raw = {k: v + 1 for k, v in ema.items()}
    ckpt = {"state_dict": raw, "state_dict_ema": ema, "epoch": 3}

    want = from_jax_variables(create_model(name, num_classes=10),
                              jax.tree.map(np.asarray, jax_load_checkpoint(ckpt, variables)))
    torch.save(ckpt, str(tmp_path / "ckpt.pth"))
    for source in (ckpt, str(tmp_path / "ckpt.pth")):
        got = load_torch_frostnet_checkpoint(
            source, from_jax_variables(create_model(name, num_classes=10),
                                       jax.tree.map(np.asarray, variables)))
        mine, theirs = model_variables(got), model_variables(want)
        assert set(mine) == set(theirs)
        for k in mine:
            assert torch.equal(mine[k], theirs[k]), k
        # every conv kernel and BN statistic came from the EMA entry
        assert torch.equal(got.layer3_1.conv2.kernel,
                           ema["module.layer3.1.conv2.conv.0.weight"].permute(2, 3, 1, 0))
    # the features backbone fills its trunk and skips the head
    feats = load_torch_frostnet_checkpoint(
        {"state_dict": ema}, FrostNetFeatures(mode="small", width_mult=0.35, quantized=True))
    assert torch.equal(feats.trunk.conv1.var, ema["module.conv1.conv.1.running_var"])
    for loader, target in ((jax_load_checkpoint, variables), (load_torch_frostnet_checkpoint,
                                                                create_model(name))):
        with pytest.raises(ValueError, match="no weights matched"):
            loader({"fc.weight": torch.zeros(3)}, target)
