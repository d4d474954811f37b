"""The plain reference against the port's plain path at a tiny size, and the
frozen tables and cost functions against independent counts."""
import json

import pytest
import torch

from portbench import costs
from portbench.core import PACKAGE
from portbench.drivers import common
from portbench.reference import frostnet as ref
from portbench.tests import tiny

LARGE = json.loads((PACKAGE / "configs" / "frostnet_quant_large_1_0.json").read_text())


def test_names_and_order_match_the_port():
    from frostnet_tpu_torch.models import create_model

    for cfg in (LARGE, tiny.tiny_config()):
        model = create_model(cfg["model"], num_classes=cfg["arch"]["num_classes"])
        specs = ref.param_specs(cfg["arch"])
        params = [n for n, _ in model.named_parameters()]
        assert params == [n for n, _, kind in specs][:len(params)]
        named = dict(list(model.named_parameters()) + list(model.named_buffers()))
        assert {n: tuple(t.shape) for n, t in named.items()} == {n: s for n, s, _ in specs}


def test_frozen_tables():
    assert {"224x224": ref.shape_tables(LARGE["arch"], LARGE["image_size"])} == LARGE["tables"]
    t = LARGE["tables"]["224x224"]
    assert (len(t["sites"]), len(t["blocks"]), len(t["matmuls"])) == (166, 18, 3)
    assert LARGE["parameters"] == sum(
        torch.Size(s).numel() for n, s, kind in ref.param_specs(LARGE["arch"])
        if kind in ("kernel", "ones", "zeros") and not n.endswith((".mean", ".var")))
    assert LARGE["forward_flops"] == {"224x224": costs.conv_flops(t["convs"])}


def test_forward_flops_against_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    weights = common.make_weights(ref.param_specs(LARGE["arch"]), 0, torch.device("cpu"))
    model = ref.FrostNetReference(LARGE["arch"], weights)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model.forward_train(torch.zeros(1, 224, 224, 3), False, torch.Generator())
    assert counter.get_total_flops() == LARGE["forward_flops"]["224x224"]
    assert LARGE["forward_flops"]["224x224"] == pytest.approx(0.862e9, rel=1e-3)


def test_costs_by_hand():
    # a 1000-element float32 site: x read, y and the mask written, the state
    assert costs.fq_cost(1000) == (9016, 10000.0)
    # the classifier at batch 8: x 8x1280, w 1280x1000, three vectors, out 8x1000
    assert costs.matmul_cost(8, 1280, 1000) == (8 * 1280 + 1280 * 1000 + 12 * 1000 + 8000,
                                               2.0 * 8 * 1280 * 1000)
    # layer2_1 at batch 1: 28x28x40 in and out, squeeze 16 (cat 56), expand 168, 3x3
    nbytes, nops = costs.block_cost(28, 28, 40, 40, 3, 1, 16, 168, True, 1)
    weights = 40 * 16 + 56 * 168 + 9 * 168 + 168 * 40
    assert nbytes == 2 * 28 * 28 * 40 + weights + 12 * (16 + 168 + 168 + 40)
    assert nops == 2.0 * 28 * 28 * (40 * 16 + 56 * 168 + 168 * 9 + 168 * 40)
    assert LARGE["tables"]["224x224"]["blocks"][4][:9] == ["layer2_1", 28, 28, 40, 40, 3, 1, 16,
                                                           168]


def _tiny_weights(seed=3):
    cfg = tiny.tiny_config()
    return cfg, common.make_weights(ref.param_specs(cfg["arch"]), seed, torch.device("cpu"))


def test_training_steps_match_the_port():
    """Two FP32 and three QAT steps of the port's train step against the
    reference, on one set of weights and batches: the same losses to
    rounding, the same gradients and parameters."""
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.nn.mode import FP32, QAT
    from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu_torch.train.state import TrainState, make_train_step

    cfg, w = _tiny_weights()
    model = create_model(cfg["model"], num_classes=10)
    common.load_weights(model, w)
    tx = get_optimizer("QSGD", 0.004, weight_decay=grouped_weight_decay(4e-5), seed=11)
    state = TrainState(model, tx(model.parameters()), torch.Generator().manual_seed(5))
    model_ref = ref.FrostNetReference(cfg["arch"], w)
    opt = ref.QSGDReference(model_ref.params, 0.004, 4e-5, noise_seed=11)
    gen = torch.Generator().manual_seed(5)
    g = torch.Generator().manual_seed(9)
    for i in range(5):
        image = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, generator=g)
        label = torch.randint(0, 10, (8,), generator=g)
        if i == 2:
            state.start_qat()
            opt.is_warmup = False
        step = make_train_step(FP32 if i < 2 else QAT, num_classes=10)
        loss = step(state, {"image": image, "label": label})["loss"]
        logits = model_ref.forward_train(ref.prep_image(image), i >= 2, gen)
        loss_ref = torch.nn.functional.cross_entropy(logits, label)
        for p in model_ref.params:
            p.grad = None
        loss_ref.backward()
        opt.step()
        assert float(loss) == pytest.approx(float(loss_ref.detach()), rel=1e-6)
        for n, p in model.named_parameters():
            assert torch.equal(p.grad, model_ref.state[n].grad), n
            assert torch.equal(p.detach(), model_ref.state[n].detach()), n


def test_int8_logits_match_the_port(tmp_path):
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.quant import export_int8
    from frostnet_tpu_torch.serve import Int8Predictor
    from frostnet_tpu_torch.train.state import TrainState, recalibrate

    cfg, w = _tiny_weights()
    g = torch.Generator().manual_seed(4)
    calib = [torch.randn(4, 32, 32, 3, generator=g) for _ in range(5)]
    model = create_model(cfg["model"], num_classes=10)
    common.load_weights(model, w)
    recalibrate(TrainState(model, None, torch.Generator()), [{"image": c} for c in calib], seed=7)
    export_int8(model, str(tmp_path / "m.npz"))
    pred = Int8Predictor(cfg["model"], num_classes=10, artifact=str(tmp_path / "m.npz"),
                         image_size=32, fuse_int8=True, device="cpu")
    model_ref = ref.FrostNetReference(cfg["arch"], w)
    model_ref.calibrate(calib, 7)
    model_ref.freeze()
    x = torch.randn(3, 32, 32, 3, generator=g)
    assert torch.equal(pred(x), model_ref.forward_int8(x))
