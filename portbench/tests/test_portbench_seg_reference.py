"""The segmenter's plain reference against the port's plain path at a small
size, and its frozen tables against the flop counter."""
import json
import tempfile

import pytest
import torch

from portbench.core import PACKAGE
from portbench.drivers import common
from portbench.reference import seg_mobilenetv3 as ref

SEG = json.loads((PACKAGE / "configs" / "seg_mobilenetv3_large.json").read_text())
CPU = torch.device("cpu")


def _port_model():
    from frostnet_tpu_torch.segmentation.models import get_seg_model

    return get_seg_model(SEG["model"], num_classes=19, dataset=SEG["dataset"])


def test_names_and_order_match_the_port():
    model = _port_model()
    specs = ref.param_specs(SEG["arch"])
    params = [n for n, _ in model.named_parameters()]
    assert params == [n for n, _, _ in specs][:len(params)]
    named = dict(list(model.named_parameters()) + list(model.named_buffers()))
    assert {n: tuple(t.shape) for n, t in named.items()} == {n: s for n, s, _ in specs}
    assert SEG["parameters"] == sum(p.numel() for p in model.parameters())


def test_the_recipe_constants_match_the_port():
    from frostnet_tpu_torch.segmentation.data import CITYSCAPES_CLASS_WEIGHTS

    assert SEG["class_weights"] == [float(x) for x in CITYSCAPES_CLASS_WEIGHTS]


@pytest.mark.parametrize("size", [(512, 1024), (768, 768)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_tables_and_flops(size):
    key = f"{size[0]}x{size[1]}"
    assert ref.shape_tables(SEG["arch"], size) == SEG["tables"][key]
    assert len(SEG["tables"][key]["matmuls"]) == 34
    from torch.utils.flop_counter import FlopCounterMode

    weights = common.make_weights(ref.param_specs(SEG["arch"]), 0, CPU)
    model = ref.SegReference(SEG["arch"], weights)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model.forward_train(torch.zeros(1, *size, 3), False)
    assert counter.get_total_flops() == SEG["forward_flops"][key]
    want = {"512x1024": 6.397e9, "768x768": 7.196e9}[key]
    assert SEG["forward_flops"][key] == pytest.approx(want, rel=1e-3)


def test_int8_logits_match_the_port():
    from frostnet_tpu_torch.quant import export_int8
    from frostnet_tpu_torch.serve import seg_predictor
    from frostnet_tpu_torch.train.state import TrainState, recalibrate

    weights = common.make_weights(ref.param_specs(SEG["arch"]), 3, CPU)
    g = torch.Generator().manual_seed(1)
    calib = [torch.randn(2, 64, 128, 3, generator=g) for _ in range(3)]
    model = _port_model()
    common.load_weights(model, weights)
    recalibrate(TrainState(model, None, torch.Generator()), [{"image": c} for c in calib], seed=7)
    with tempfile.TemporaryDirectory() as d:
        export_int8(model, f"{d}/m.npz")
        pred = seg_predictor(SEG["model"], f"{d}/m.npz", 19, 64, device="cpu")
    model_ref = ref.SegReference(SEG["arch"], weights)
    model_ref.calibrate(calib)
    model_ref.freeze()
    x = torch.randn(2, 64, 128, 3, generator=g)
    assert torch.equal(pred(x), model_ref.forward_int8(x))


def test_training_steps_match_the_port():
    """An FP32 step from the seeded weights and a QAT step from the port's
    state after it: the same loss to rounding, the same gradients."""
    from frostnet_tpu_torch.nn.mode import FP32, QAT
    from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu_torch.segmentation.train import make_seg_train_step
    from frostnet_tpu_torch.train.state import TrainState

    weights = common.make_weights(ref.param_specs(SEG["arch"]), 5, CPU)
    model = _port_model()
    common.load_weights(model, weights)
    tx = get_optimizer("QSGD", 0.005, weight_decay=grouped_weight_decay(4e-5), seed=11)
    state = TrainState(model, tx(model.parameters()), torch.Generator())
    g = torch.Generator().manual_seed(2)
    w = torch.tensor(SEG["class_weights"])
    for i, mode in enumerate((FP32, QAT)):
        image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=g)
        label = torch.randint(0, 19, (2, 64, 64), generator=g)
        label[:, ::5, ::3] = 255
        named = dict(list(model.named_parameters()) + list(model.named_buffers()))
        model_ref = ref.SegReference(SEG["arch"], {n: t.detach().clone() for n, t in named.items()})
        if i == 1:
            state.start_qat()
        step = make_seg_train_step(mode, SEG["class_weights"], 255, 19)
        loss = step(state, {"image": image, "label": label})["loss"]
        logits = model_ref.forward_train(ref.prep_image(image), i == 1)
        loss_ref = torch.nn.functional.cross_entropy(logits.reshape(-1, 19), label.reshape(-1),
                                                     weight=w, ignore_index=255)
        loss_ref.backward()
        assert float(loss) == pytest.approx(float(loss_ref.detach()), rel=1e-5)
        for n, p in model.named_parameters():
            r = model_ref.state[n].grad
            assert torch.allclose(p.grad, r, rtol=1e-4, atol=1e-6 * float(r.abs().max())), n
