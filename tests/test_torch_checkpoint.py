"""PyTorch port, checkpoints: a resume continues bit for bit as if never stopped.

``frostnet_quant_small_0_35`` at 32x32 on the CPU: four train steps straight
against two steps, ``save_checkpoint``, ``restore_checkpoint`` into a fresh
state (another seed, so that nothing survives by accident), two more steps.
Every parameter, BN statistic and observer, the optimizer's counters and
tensors, the EMA, the step, the dropout generator and the GradBoost noise
generator must be identical. Once in the StatAssist warm-up (FP32 steps,
GradBoost EMAs only), once across the noise phase (the noise generator is
created at the first noise step, before the save, and restored from it),
under a ``cos_lr`` schedule. ``restore_model_variables`` loads a checkpoint
into a state whose optimizer chain differs, as the JAX package's does
(``tests/test_checkpoint_compat.py``).
"""
import os

import pytest
import torch

from _torch_port import few_threads, train_batch  # noqa: F401 - a fixture
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.nn import FP32, QAT
from frostnet_tpu_torch.optim import get_lr_scheduler, get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import model_variables
from frostnet_tpu_torch.train import create_train_state, make_train_step
from frostnet_tpu_torch.utils.checkpoint import (restore_checkpoint, restore_model_variables,
                                                 save_checkpoint)

MODEL, SIZE, BATCH, CLASSES = "frostnet_quant_small_0_35", 32, 4, 10
pytestmark = pytest.mark.usefixtures("few_threads")


def _state(name, seed):
    # lr 1e-3: at random init the logits are ~30, and larger steps on 4
    # images drive this small model's weights to inf within a few steps
    tx = get_optimizer(name, get_lr_scheduler("cos_lr", base_lr=1e-3, total_steps=8),
                       weight_decay=grouped_weight_decay(4e-5))
    return create_train_state(create_model(MODEL, num_classes=CLASSES), tx, seed=seed,
                              device="cpu", ema_decay=0.9)


def _run(state, steps, phase):
    """Train steps ``steps`` of the ``phase`` schedule: "warmup" is FP32
    throughout; "noise" is one FP32 step, ``start_qat``, then QAT."""
    fp = make_train_step(FP32, num_classes=CLASSES, ema_decay=0.9)
    qat = make_train_step(QAT, num_classes=CLASSES, ema_decay=0.9)
    for k in steps:
        if phase == "noise" and k == 1:
            state.start_qat()
        step = fp if phase == "warmup" or k == 0 else qat
        step(state, train_batch(k, BATCH, SIZE, CLASSES))
    return state


def _assert_same(a, b):
    va, vb = model_variables(a.model), model_variables(b.model)
    assert set(va) == set(vb)
    for k in va:
        assert torch.equal(va[k], vb[k]), k
        assert not k.startswith("params/") or torch.isfinite(va[k]).all(), k
    assert a.step == b.step
    assert set(a.ema) == set(b.ema) and all(torch.equal(a.ema[k], b.ema[k]) for k in a.ema)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    oa, ob = a.optimizer, b.optimizer
    for ga, gb in zip(oa.param_groups, ob.param_groups):
        for key in ("count", "gb_step", "restart_step", "is_warmup"):
            assert ga.get(key) == gb.get(key), key
    assert set(oa.state) == set(ob.state)
    for key in oa.state:
        sa, sb = oa.state[key], ob.state[key]
        assert set(sa) == set(sb), key
        for n in sa:
            if sa[n] is None:
                assert sb[n] is None, n
            else:
                assert torch.equal(sa[n], sb[n]), n
    ga, gb = getattr(oa, "generator", None), getattr(ob, "generator", None)
    assert (ga is None) == (gb is None)
    if ga is not None:
        assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.parametrize("name", ["QSGD", "QAdamW"])
@pytest.mark.parametrize("phase", ["warmup", "noise"])
def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path, phase, name):
    straight = _run(_state(name, 0), range(4), phase)
    first = _run(_state(name, 0), range(2), phase)
    if phase == "noise":
        assert first.optimizer.generator is not None  # the noise phase has begun
        assert not first.optimizer.param_groups[0]["is_warmup"]
    path = str(tmp_path / "checkpoint")
    save_checkpoint(path, first)
    assert os.listdir(path) == ["state.pt"]
    resumed = restore_checkpoint(path, _state(name, 1))
    _assert_same(resumed, first)
    if phase == "noise":
        resumed.start_qat()  # what the trainer does on a resume (idempotent)
    _run(resumed, range(2, 4), phase)
    _assert_same(resumed, straight)
    group = resumed.optimizer.param_groups[0]
    assert group["count"] == 4 and group["restart_step"] == (3 if phase == "noise" else 0)


def test_a_save_overwrites_the_directory(tmp_path):
    path = str(tmp_path / "ckpt")
    a = _run(_state("QSGD", 0), range(1), "warmup")
    save_checkpoint(path, a)
    _run(a, range(1, 2), "warmup")
    save_checkpoint(path, a)
    b = restore_checkpoint(path, _state("QSGD", 3))
    _assert_same(a, b)


def test_restore_model_variables_across_optimizer_chains(tmp_path):
    trained = _run(_state("QSGD", 0), range(2), "noise")
    path = str(tmp_path / "best")
    save_checkpoint(path, trained)
    other = create_train_state(create_model(MODEL, num_classes=CLASSES),
                               get_optimizer("Adam", 1e-3), seed=5, device="cpu")
    with pytest.raises(ValueError, match="restore_model_variables"):
        restore_checkpoint(path, other)
    restore_model_variables(path, other)
    va, vb = model_variables(trained.model), model_variables(other.model)
    assert all(torch.equal(va[k], vb[k]) for k in va)
    assert other.step == trained.step == 2
    assert all(torch.equal(other.ema[k], trained.ema[k]) for k in trained.ema)
    assert other.optimizer.param_groups[0]["count"] == 0  # the optimizer is untouched
    with pytest.raises(FileNotFoundError):
        restore_model_variables(str(tmp_path / "missing"), other)
    wrong = create_train_state(create_model("frostnet_quant_small_0_5", num_classes=CLASSES),
                               get_optimizer("QSGD", 1e-3), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        restore_model_variables(path, wrong)
