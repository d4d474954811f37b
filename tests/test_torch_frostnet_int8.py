"""PyTorch port, the INT8 FrostNet slice end to end on the CPU.

A JAX FrostNet is calibrated (random init + two QAT forwards), exported with
``export_int8`` and served by JAX ``freeze``; the port loads the artifact
(``load_int8`` + ``from_jax_variables``), freezes it fused and unfused, and
must give the same logits bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import calibrated_jax_variables
from frostnet_tpu.quant import export_int8, freeze as jax_freeze, get_qconfig as jax_qconfig
from frostnet_tpu.quant import load_int8 as jax_load_int8
from frostnet_tpu_torch import ops
from frostnet_tpu_torch.models import create_model, list_models
from frostnet_tpu_torch.nn import INT8
from frostnet_tpu_torch.quant import freeze, from_jax_variables, get_qconfig, load_int8
from frostnet_tpu_torch.quant.export import flatten_variables, model_variables

CASES = [("frostnet_quant_small_0_35", "qnnpack", 32),
         ("frostnet_quant_small_0_35", "fbgemm", 32),
         ("frostnet_quant_large_1_0", "qnnpack", 32)]


@pytest.mark.parametrize("name,backend,size", CASES)
def test_port_serves_jax_artifact_bit_exact(tmp_path, name, backend, size):
    model, variables, images = calibrated_jax_variables(name, backend, size)
    path = str(tmp_path / "int8.npz")
    export_int8(variables, path, qconfig=jax_qconfig(backend))
    want = np.asarray(jax_freeze(model, jax_load_int8(path))(jnp.asarray(images)))

    ops.reset_launch_counts()
    for fuse in (False, True):
        port = create_model(name, num_classes=10, qconfig=get_qconfig(backend), fuse_int8=fuse)
        from_jax_variables(port, load_int8(path))
        got = freeze(port, device="cpu", image_size=size)(images)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert ops.launch_counts() == {"int8_matmul_requant": 0, "frost_block_int8": 0,
                                   "fake_quant_observe": 0, "int8_conv": 0,
                                   "depthwise_int8": 0, "resize_bilinear": 0}


def test_port_serves_calibrated_variables_bit_exact():
    """from_jax_variables on a training tree (BN not folded): the port folds
    at freeze as XLA folds the frozen JAX graph."""
    name, backend, size = "frostnet_quant_small_0_35", "fbgemm", 32
    model, variables, images = calibrated_jax_variables(name, backend, size, seed=1)
    want = np.asarray(jax_freeze(model, variables)(jnp.asarray(images)))
    for fuse in (False, True):
        port = create_model(name, num_classes=10, qconfig=get_qconfig(backend), fuse_int8=fuse)
        from_jax_variables(port, jax.tree.map(np.asarray, variables))
        np.testing.assert_array_equal(freeze(port, "cpu", size)(images).numpy(), want)


@pytest.mark.parametrize("name,backend", [("frostnet_quant_large_1_0", "qnnpack"),
                                          ("frostnet_quant_small_0_35", "fbgemm"),
                                          ("frostnet_quant_base_1_25", "qnnpack")])
def test_variable_names_and_shapes_match_jax(name, backend):
    from frostnet_tpu.models import create_model as jax_create_model

    jmodel = jax_create_model(name, qconfig=jax_qconfig(backend))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = {k: tuple(v.shape) for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    port = create_model(name, qconfig=get_qconfig(backend))
    got = {k: tuple(v.shape) for k, v in model_variables(port).items()}
    assert got == want


def test_registry_and_float_names():
    names = list_models("frostnet")
    assert len(names) == 30
    # the float FrostNets build (no QuantStub, no observers) and are not frozen
    float_model = create_model("frostnet_large_1_0")
    assert not float_model.quantized and not hasattr(float_model, "quant")
    assert not any(k.startswith("quant/") for k in model_variables(float_model))
    # a JAX name of another family, ported since: it builds (float, no observers)
    other = create_model("shufflenet_v2_x1_0")
    assert not other.quantized and not any(k.startswith("quant/") for k in model_variables(other))
    with pytest.raises(ValueError):
        create_model("frostnet_huge_1_0")


def test_forward_needs_freeze():
    port = create_model("frostnet_quant_small_0_35", num_classes=10)
    with pytest.raises(RuntimeError, match="freeze"):
        port(torch.zeros(1, 32, 32, 3), mode=INT8)


def test_from_jax_variables_rejects_mismatched_trees():
    port = create_model("frostnet_quant_small_0_35", num_classes=10)
    tree = {"params": {"conv1": {"kernel": np.zeros((3, 3, 3, 16), np.float32)}}}
    with pytest.raises(ValueError, match="missing"):
        from_jax_variables(port, tree)
