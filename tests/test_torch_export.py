"""PyTorch port, ``export_int8``: the JAX package's artifact, written from a port-trained model.

``frostnet_quant_small_0_35`` at 32x32 trains in the port on the CPU (one
FP32 step, ``start_qat``, two QAT steps; qnnpack and fbgemm). Its artifact
must hold the keys and arrays, bit for bit, of the JAX package's
``export_int8`` of the same variables; and JAX's ``load_int8`` + ``freeze``
of it must give the logits, bit for bit, of the port's ``load_int8`` +
``freeze`` and of the port's in-process ``freeze`` of the trained model.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_variables, train_batch  # noqa: F401 - a fixture
from frostnet_tpu import quant as jq
from frostnet_tpu.models import create_model as jax_create_model
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.nn import FP32, QAT
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import (export_int8, freeze, from_jax_variables, get_qconfig,
                                      load_int8, model_variables)
from frostnet_tpu_torch.quant.export import unflatten_variables
from frostnet_tpu_torch.train import create_train_state, make_train_step

MODEL, SIZE, BATCH, CLASSES = "frostnet_quant_small_0_35", 32, 8, 10
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module", params=["qnnpack", "fbgemm"])
def trained(request):
    backend = request.param
    model = create_model(MODEL, num_classes=CLASSES, qconfig=get_qconfig(backend))
    tx = get_optimizer("QSGD", 1e-3, weight_decay=grouped_weight_decay(4e-5))
    state = create_train_state(model, tx, seed=0, device="cpu")
    make_train_step(FP32, num_classes=CLASSES)(state, train_batch(0, BATCH, SIZE, CLASSES))
    state.start_qat()
    qat = make_train_step(QAT, num_classes=CLASSES)
    for k in (1, 2):
        qat(state, train_batch(k, BATCH, SIZE, CLASSES))
    tree = unflatten_variables({k: v.detach().numpy().copy()
                                for k, v in model_variables(state.model).items()})
    return backend, state.model, tree


def test_artifact_equals_the_jax_export(trained, tmp_path):
    backend, model, tree = trained
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    n = export_int8(model, mine)
    jq.export_int8(jax_variables(tree), theirs, qconfig=jq.get_qconfig(backend))
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert json.loads(bytes(a["__meta__"]).decode())["qconfig"] == backend
        kernels = [k for k in a.files if k.endswith("/kernel")]
        assert kernels and all(a[k].dtype == np.int8 for k in kernels)
    assert n == (tmp_path / "port.npz").stat().st_size
    # a variables tree exports the same bytes as the model
    export_int8(tree, str(tmp_path / "tree"), qconfig=get_qconfig(backend))
    with np.load(mine) as a, np.load(str(tmp_path / "tree.npz")) as c:
        assert all(np.array_equal(a[k], c[k]) for k in a.files)


def test_served_logits_equal_across_packages(trained, tmp_path):
    backend, model, tree = trained
    path = str(tmp_path / "model_int8.npz")
    export_int8(model, path)
    images = np.random.RandomState(9).randn(4, SIZE, SIZE, 3).astype(np.float32)

    jmodel = jax_create_model(MODEL, num_classes=CLASSES, qconfig=jq.get_qconfig(backend))
    want = np.asarray(jq.freeze(jmodel, jq.load_int8(path))(jnp.asarray(images)))

    port = create_model(MODEL, num_classes=CLASSES, qconfig=get_qconfig(backend))
    from_jax_variables(port, load_int8(path))
    from_artifact = freeze(port, device="cpu", image_size=SIZE)(images).numpy()
    in_process = create_model(MODEL, num_classes=CLASSES, qconfig=get_qconfig(backend))
    in_process.load_state_dict(model.state_dict())
    direct = freeze(in_process, device="cpu", image_size=SIZE)(images).numpy()

    np.testing.assert_array_equal(from_artifact, want)
    np.testing.assert_array_equal(direct, want)
    assert len(np.unique(want)) > 8 and np.isfinite(want).all()


def test_export_needs_the_kernels_observed(tmp_path):
    """An artifact written before any observer step holds the (1.0, 0)
    qparams of uninitialized observers, as the JAX export does."""
    model = create_model(MODEL, num_classes=CLASSES)
    export_int8(model, str(tmp_path / "fresh"))
    with np.load(str(tmp_path / "fresh.npz")) as a:
        assert np.isinf(a["quant/conv1/w_obs.min_val"]).all()
    assert isinstance(load_int8(str(tmp_path / "fresh"))["params"]["conv1"]["kernel"],
                      np.ndarray)
    assert torch.isinf(model.conv1.w_obs.min_val).all()
