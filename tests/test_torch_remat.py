"""``make_train_step(remat=...)`` (JAX ``train/state.py:116-161``): the
forward under ``torch.utils.checkpoint``, replayed in the backward.

On the CPU, ``"full"`` (and ``True``) and ``"conv_outs"`` (the conv outputs
kept by a selective-checkpoint policy) give the plain step bit for bit
over an FP32 and two QAT steps of ``frostnet_quant_small_0_35`` with
dropout and GradBoost noise: the losses, parameters, BN statistics and
observers. Each block runs twice a step (its replay happened), and every
BN statistic and observer still stepped once: a second step of an EMA
observer or of a running mean would move it (JAX's round-2 failure,
``tests/test_remat_step.py``).
"""
import numpy as np
import pytest
import torch

from _torch_port import few_threads, train_batch  # noqa: F401 - a fixture
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.nn import FP32, QAT
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import model_variables
from frostnet_tpu_torch.train import create_train_state, make_train_step

pytestmark = pytest.mark.usefixtures("few_threads")

MODEL, SIZE, BATCH, CLASSES = "frostnet_quant_small_0_35", 32, 4, 10
PHASES = (FP32, QAT, QAT)


def _run(remat):
    """The three steps; (losses, variables, runs of one block a step)."""
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5))
    state = create_train_state(create_model(MODEL, num_classes=CLASSES, drop_rate=0.2), tx,
                               seed=0, device="cpu")
    calls, block = [], state.model.layer2_0
    forward = block.forward

    def counted(*args, **kwargs):  # a replay may stop early: no forward hook runs
        calls.append(1)
        return forward(*args, **kwargs)

    block.forward = counted
    losses, forwards = [], []
    for k, mode in enumerate(PHASES):
        if k == 1:
            state.start_qat()
        before = len(calls)
        m = make_train_step(mode, num_classes=CLASSES, remat=remat)(
            state, train_batch(k, BATCH, SIZE, CLASSES))
        losses.append(float(m["loss"]))
        forwards.append(len(calls) - before)
    return losses, {k: v.detach().clone() for k, v in model_variables(state.model).items()}, \
        forwards


@pytest.fixture(scope="module")
def plain():
    return _run(False)


@pytest.mark.parametrize("remat", ["full", True, "conv_outs"])
def test_remat_step_is_the_plain_step(plain, remat):
    losses, variables, forwards = _run(remat)
    assert forwards == [2, 2, 2] and plain[2] == [1, 1, 1]
    assert losses == plain[0]
    assert sorted(variables) == sorted(plain[1])
    differ = [k for k in variables if not torch.equal(variables[k], plain[1][k])]
    assert not differ, differ[:8]
    stepped = [k for k in variables if k.endswith(".max_val") or k.endswith("/mean")]
    assert len(stepped) > 100 and all(np.isfinite(variables[k].numpy()).all() for k in stepped)


def test_remat_refuses_an_unknown_policy():
    state = create_train_state(create_model(MODEL, num_classes=CLASSES), None, seed=0,
                               device="cpu")
    state.optimizer = get_optimizer("SGD", 0.1)(state.model.parameters())
    with pytest.raises(ValueError, match="remat is False"):
        make_train_step(FP32, num_classes=CLASSES, remat="dots")(
            state, train_batch(0, BATCH, SIZE, CLASSES))
