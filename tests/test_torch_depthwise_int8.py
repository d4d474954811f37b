"""PyTorch port, the INT8 depthwise conv with its requant epilogue
(``ops/depthwise_int8.py`` -> ``csrc/depthwise_int8.cu``).

On the CPU (a few seconds): over a grid of shapes (kernel 3, 5 and (3, 5),
stride 1 and 2, dilation 1 and 2, asymmetric padding, channel multiplier 1
and 4, 3, 24 and 72 channels, the ReLU and ReLU6 code ranges, the merged
constants of a conv with no activation, per-tensor scale and zero bias) the
wrapper equals ``depthwise_acc`` then ``requant_epilogue``, and both equal an
independent float64 grouped conv (``conv_acc``) through the same epilogue;
``QConvBNAct``'s depthwise route goes through the wrapper (its span, no
launch on the CPU); an exported program holds the kernel's op
``frostnet::depthwise_int8``, which takes the operands by name, and gives
the plain version's codes at two batch sizes; the 15 depthwise convs of the
segmentation cell (``scripts/time_depthwise_int8.py::seg_shapes``, from the
benchmark's configuration and the port's model) and the benchmark's
``depthwise_roofline.serve`` bound there, 355.6 MB, 0.106 ms a request.

On the card (marker ``cuda``; no JAX, so ``--noconftest`` runs it): the kernel
bit-exact to the plain version over the same grid, on codes at an odd byte
offset, and at the 15 depthwise convs of the served segmentation trunk at
batch 2; an exported program launches it; 15 launches a served segmentation
forward and none a fused FrostNet one; a strided or non-uint8 input
refused.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from frostnet_tpu_torch import ops
from frostnet_tpu_torch.ops import cuda_build
from frostnet_tpu_torch.ops.depthwise_int8 import (DepthwiseOperands, depthwise_int8,
                                                   depthwise_int8_plain, depthwise_operands)
from frostnet_tpu_torch.ops.requant import (conv_acc, depthwise_acc, reciprocal,
                                            requant_epilogue)
from scripts.time_depthwise_int8 import cost, seg_cell, seg_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (C, m, kernel, stride, dilation, padding or None for 'same', epilogue)
GRID = [
    (24, 1, 3, 1, 1, None, "relu"),
    (24, 1, 3, 2, 1, None, "relu6"),
    (72, 1, 5, 1, 2, None, "relu"),
    (72, 1, 5, 2, 1, None, "none"),
    (3, 1, 3, 1, 1, None, "relu"),
    (3, 1, (3, 5), 1, 1, None, "merged"),
    (24, 1, (3, 5), 2, 2, (1, 3), "relu6"),
    (24, 4, 3, 2, 1, None, "none"),
    (3, 4, 5, 1, 2, (3, 1), "relu"),
    (72, 4, (3, 5), 1, 1, (0, 2), "merged"),
    (72, 1, 3, 1, 2, (2, 0), "relu6"),
    (24, 1, 5, 2, 2, (1, 4), "merged"),
]

EXPORTED = [GRID[1], GRID[6], GRID[7], GRID[9]]


def _case(c, m, kernel, stride, dilation, padding, epilogue, seed, device="cpu", size=(9, 11),
          batch=2):
    """(x, operands) of one depthwise conv with random codes, taps and
    epilogue constants."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    if padding is None:
        padding = (dilation * (kh - 1) // 2, dilation * (kw - 1) // 2)
    g = torch.Generator().manual_seed(seed)
    cout = c * m
    x = torch.randint(0, 256, (batch, *size, c), generator=g, dtype=torch.uint8)
    qw = torch.randint(-128, 128, (kh, kw, 1, cout), generator=g, dtype=torch.int8)
    in_scale = torch.tensor(0.02, dtype=torch.float32)
    relu = epilogue in ("relu", "relu6")
    if epilogue == "merged":
        comb, bias = in_scale * 0.01, torch.zeros(cout)
    else:
        comb = in_scale * (0.004 + 0.01 * torch.rand(cout, generator=g))
        bias = torch.randn(cout, generator=g)
    out_scale, out_zp = 0.05 + 0.1 * float(torch.rand((), generator=g)), 0 if relu else 128
    qmin, qmax = 0, 255
    if epilogue == "relu6":
        qmax = int(round(6.0 * reciprocal(out_scale)))
    zp = int(torch.randint(0, 256, (), generator=g))
    op = depthwise_operands(qw, comb, bias, zp, out_scale, out_zp, relu, qmin, qmax, stride,
                            dilation, padding, device)
    return x.to(device), op


@pytest.mark.parametrize("cfg", GRID, ids=lambda c: "-".join(map(str, c)).replace(" ", ""))
def test_wrapper_equals_plain_and_grouped_conv(cfg):
    x, op = _case(*cfg, seed=len(str(cfg)))
    (kh, kw), c = op.kernel, x.shape[3]
    plain = requant_epilogue(
        depthwise_acc(x, op.taps, op.kernel, op.stride, op.zp_in, op.dilation, op.padding),
        op.scale, op.bias, op.out_mult, op.out_zp, op.relu, op.qmin, op.qmax)
    wc = op.taps.to(torch.float64).t().reshape(op.cout, 1, kh, kw)
    grouped = requant_epilogue(
        conv_acc(x, wc, op.zp_in, op.stride, op.padding, groups=c, dilation=op.dilation),
        op.scale, op.bias, op.out_mult, op.out_zp, op.relu, op.qmin, op.qmax)
    got = depthwise_int8(x, op)
    assert got.dtype == torch.uint8 and got.shape == (x.shape[0], *op.out_hw(9, 11), op.cout)
    assert torch.equal(got, plain) and torch.equal(plain, grouped)
    assert len(torch.unique(got)) > 16  # the codes spread over the grid
    if cfg[-1] == "relu6":
        assert int(got.max()) <= op.qmax < 255
    if cfg[-1] == "merged":
        assert not op.relu and op.out_mult == 1.0 and bool((op.bias == 0).all())


def _dw_layer(c, m, kernel, stride, dilation, act):
    from frostnet_tpu_torch.nn import QConvBNAct

    g = torch.Generator().manual_seed(c * m + stride)
    conv = QConvBNAct(c, c * m, kernel, strides=stride, padding=dilation * (kernel - 1) // 2,
                      dilation=dilation, groups=c, act=act)
    with torch.no_grad():
        conv.kernel.copy_(torch.randn(conv.kernel.shape, generator=g) * 0.3)
        conv.bias_bn.copy_(torch.randn(c * m, generator=g) * 0.2)
        conv.w_obs.min_val.fill_(-0.8)
        conv.w_obs.max_val.fill_(0.8)
        conv.act_obs.min_val.fill_(0.0 if act else -2.0)
        conv.act_obs.max_val.fill_(3.0)
    return conv.eval()


def test_qconv_depthwise_route_goes_through_the_wrapper():
    from torch.profiler import ProfilerActivity, profile

    from frostnet_tpu_torch.nn import INT8
    from frostnet_tpu_torch.quant import QParams, QTensor
    from frostnet_tpu_torch.utils.profiling import session

    conv = _dw_layer(24, 1, 5, 2, 1, "relu6")
    grid = QParams(0.02, 100)
    conv.prepare_int8(grid, "cpu")
    x = torch.randint(0, 256, (2, 13, 15, 24), generator=torch.Generator().manual_seed(3),
                      dtype=torch.uint8)
    launches = depthwise_int8.launches
    with profile(activities=[ProfilerActivity.CPU]):
        out = conv(QTensor(x, *grid.tensors("cpu")), mode=INT8)
    assert conv._route == "depthwise" and [r.name for r in session()] == ["ops.depthwise"]
    assert depthwise_int8.launches == launches  # CPU tensors launch nothing
    assert torch.equal(out.q, depthwise_int8_plain(x, conv._op))
    assert out.q.shape == (2, 7, 8, 24) and len(torch.unique(out.q)) > 16


@pytest.mark.parametrize("cfg", EXPORTED, ids=lambda c: "-".join(map(str, c)).replace(" ", ""))
def test_exported_program_calls_the_op(cfg):
    x, op = _case(*cfg, seed=len(str(cfg)))

    class Depthwise(torch.nn.Module):
        def forward(self, x):
            return depthwise_int8(x, op)

    prog = torch.export.export(Depthwise(), (x,),
                               dynamic_shapes={"x": {0: torch.export.Dim("b")}})
    targets = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
    assert targets == ["frostnet.depthwise_int8.default"]
    want = depthwise_int8_plain(x, op)
    assert torch.equal(prog.module()(x), want) and torch.equal(prog.module()(x[:1]), want[:1])


def test_op_takes_the_operands_by_name():
    schema = torch.ops.frostnet.depthwise_int8.default._schema
    assert [a.name for a in schema.arguments] == ["x"] + [f.name for f in
                                                         dataclasses.fields(DepthwiseOperands)]
    x, op = _case(*GRID[8], seed=5)
    got = torch.ops.frostnet.depthwise_int8(x, *cuda_build.fields(op))
    assert torch.equal(got, depthwise_int8_plain(x, op))


def test_roofline_bound_of_the_seg_cell():
    reader, _, tables, batch = seg_cell()
    shapes = seg_shapes()
    assert batch == 8 and len(shapes) == 15 and shapes[0] == (256, 512, 16, 3, 1, 1)
    assert [s for *_, s, _ in shapes] == [1, 2, 1, 2, 1, 1, 2] + [1] * 8
    assert [d for *_, d in shapes] == [1] * 12 + [2] * 3
    rows = reader.depthwise_rows(tables)
    assert [(r[3], r[4]) for r in rows] == [(c, k) for _, _, c, k, _, _ in shapes]
    nbytes = sum(reader.depthwise_cost(*row, batch)[0] for row in rows)
    nops = sum(reader.depthwise_cost(*row, batch)[1] for row in rows)
    assert round(nbytes / 1e6, 1) == 355.6 and round(nops / 1e9, 2) == 4.27
    assert [cost(s) for s in shapes] == [reader.depthwise_cost(*row, batch) for row in rows]
    assert round(reader.depthwise_bound_s(tables, batch) * 1e3, 3) == 0.106


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", GRID, ids=lambda c: "-".join(map(str, c)).replace(" ", ""))
def test_kernel_bit_exact_over_the_grid(cuda_device, cfg):
    for size in ((9, 11), (37, 70)):
        x, op = _case(*cfg, seed=len(str(cfg)), device=cuda_device, size=size)
        got = depthwise_int8(x, op)
        assert torch.equal(got.cpu(), depthwise_int8_plain(x, op).cpu())


@pytest.mark.cuda
def test_kernel_bit_exact_at_an_odd_byte_offset(cuda_device):
    """Codes that start one byte into their storage (a contiguous view): the
    kernel takes byte loads there, not the 4-byte words of aligned codes."""
    for cfg in (GRID[0], GRID[2], GRID[10]):
        x, op = _case(*cfg, seed=11, device=cuda_device, size=(21, 34))
        buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda_device)
        odd = buf[1:].view(x.shape)
        odd.copy_(x)
        assert odd.is_contiguous() and odd.data_ptr() % 4 == 1
        assert torch.equal(depthwise_int8(odd, op), depthwise_int8_plain(x, op))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_exported_program_launches_the_kernel(cuda_device):
    x, op = _case(*GRID[6], seed=12, device=cuda_device, size=(30, 41))

    class Depthwise(torch.nn.Module):
        def forward(self, x):
            return depthwise_int8(x, op)

    prog = torch.export.export(Depthwise(), (x,),
                               dynamic_shapes={"x": {0: torch.export.Dim("b")}}).module()
    before = depthwise_int8.launches
    got = prog(x)
    assert depthwise_int8.launches == before + 1
    assert torch.equal(got, depthwise_int8_plain(x, op))


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(15))
def test_kernel_bit_exact_at_the_seg_shapes(cuda_device, i):
    h, w, c, k, s, d = seg_shapes()[i]
    for epilogue in ("relu", "none"):
        x, op = _case(c, 1, k, s, d, None, epilogue, seed=c + k, device=cuda_device,
                      size=(h, w))
        before = depthwise_int8.launches
        got = depthwise_int8(x, op)
        assert depthwise_int8.launches == before + 1
        assert torch.equal(got, depthwise_int8_plain(x, op))


@pytest.mark.cuda
def test_launches_per_served_forward(cuda_device, tmp_path):
    """15 launches a served segmentation forward (``mobilenetv3_large``, the
    committed fixture), none a fused FrostNet one; the segmentation
    forward's output as the CPU's."""
    from chip_smoke import seg_served_model
    from frostnet_tpu_torch.serve import Int8Predictor

    _, fn = seg_served_model("mobilenetv3_large", cuda_device, str(tmp_path))
    images = np.random.RandomState(0).randn(1, 768, 768, 3).astype(np.float32)
    ops.reset_launch_counts()
    logits = fn(images)
    torch.cuda.synchronize()
    assert ops.launch_counts()["depthwise_int8"] == 15 and logits.device.type == "cuda"
    artifact = os.path.join(ROOT, "frostnet_tpu_torch", "testdata",
                            "frostnet_quant_large_1_0_int8.npz")
    pred = Int8Predictor(artifact=artifact, fuse_int8=True, device=cuda_device)
    ops.reset_launch_counts()
    pred(np.random.RandomState(1).randn(2, 224, 224, 3).astype(np.float32))
    torch.cuda.synchronize()
    assert ops.launch_counts()["depthwise_int8"] == 0


@pytest.mark.cuda
def test_kernel_refuses_strided_and_non_uint8_inputs(cuda_device):
    x, op = _case(24, 1, 3, 1, 1, None, "relu", seed=9, device=cuda_device, size=(8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_int8(x.permute(0, 2, 1, 3), op)
    with pytest.raises(TypeError, match="uint8"):
        depthwise_int8(x.to(torch.int32), op)
