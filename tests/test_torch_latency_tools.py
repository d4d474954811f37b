"""PyTorch port, the latency probe and its FLOPs and profiling utils.

* ``count_params`` equals JAX's on the same model's variables (BN
  statistics and observers are not parameters in either).
* ``compute_flops`` (``FlopCounterMode``: convolutions and matrix products,
  2 FLOPs a multiply-add) against XLA's cost analysis of the JAX FP32
  forward (``frostnet_small_0_35`` at 64x64, batch 1): XLA also counts the
  elementwise ops (BN, ReLU, adds), so the port counts less. Measured ratio
  0.9812 (8,982,400 against 9,154,922); held in ``FLOPS_BAND``.
* ``latency_check.main`` runs on the CPU, classifier and ``--seg``, with
  ``--reps``; the profiling utils (``chain_time``, ``trace`` and
  ``load_device_trace``) run on the CPU. No time from these runs is a
  device metric.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import few_threads  # noqa: F401 - a fixture
from frostnet_tpu.models import create_model as jax_create_model
from frostnet_tpu.utils.flops import count_params as jax_count_params
from frostnet_tpu.utils.flops import model_flops_params as jax_model_flops_params
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.train import latency_check
from frostnet_tpu_torch.utils.flops import compute_flops, count_params, model_flops_params
from frostnet_tpu_torch.utils.profiling import chain_time, load_device_trace, trace

FLOPS_BAND = (0.95, 1.0)  # port / XLA cost analysis


def test_count_params_and_flops_against_jax(few_threads):  # noqa: F811
    for name in ("frostnet_quant_large_1_0", "qmobilenet_v2_ReLU", "frostnet_small_0_35"):
        jm = jax_create_model(name, num_classes=10)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        assert count_params(create_model(name, num_classes=10)) == \
            jax_count_params(shapes["params"]), name
    name, shape = "frostnet_small_0_35", (1, 64, 64, 3)
    want_flops, want_params = jax_model_flops_params(jax_create_model(name, num_classes=10),
                                                     input_shape=shape)
    flops, params = model_flops_params(create_model(name, num_classes=10), shape)
    assert params == want_params
    assert FLOPS_BAND[0] <= flops / want_flops <= FLOPS_BAND[1], flops / want_flops
    # a 1x1 conv's count by hand: 2 * B * H * W * Cin * Cout
    conv = torch.nn.Conv2d(8, 16, 1)
    assert compute_flops(conv, torch.zeros(2, 8, 5, 5)) == 2 * 2 * 25 * 8 * 16


def test_latency_check_runs_on_the_cpu(few_threads):  # noqa: F811
    out = latency_check.cli(["--model", "frostnet_quant_small_0_35", "--num_classes", "10",
                             "--image_size", "32", "--iters", "2", "--reps", "2",
                             "--device", "cpu"])
    assert out["device"] == "cpu" and 0 < out["int8_size_mb"] < out["fp_size_mb"]
    for k in ("fp_ms", "qat_ms", "int8_ms", "fp_spread"):
        assert np.isfinite(out[k]) and out[k] >= 0
    out = latency_check.cli(["--seg", "--model", "mobilenetv3_small", "--num_classes", "5",
                             "--backend", "qnnpack", "--image_size", "64", "--iters", "1",
                             "--device", "cpu"])
    assert out["int8_ms"] > 0 and out["int8_spread"] == 0.0


def test_profiling_utils_on_the_cpu(tmp_path):
    calls = []
    ms = chain_time(lambda: calls.append(1), "cpu", iters=4, reps=2, warmup=1)
    assert len(calls) == 1 + 4 * 2 and ms >= 0
    with trace(str(tmp_path / "t")):
        torch.relu(torch.randn(32, 32))
    events, proc, _ = load_device_trace(str(tmp_path / "t"))
    assert any("relu" in e.get("name", "") for e in events) and proc
    assert load_device_trace(str(tmp_path / "empty")) is None
