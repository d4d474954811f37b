"""PyTorch port, the bilinear resize kernel (``ops/resize.py`` ->
``csrc/resize_bilinear.cu``) against the plain version, bit for bit.

The plain version (``resize_bilinear_plain``, the torch-op passes of
``_interp``) is the oracle: ``tests/test_torch_resize.py`` holds it to the
JAX function. The kernel must give its bits at every size it is held to
there, at the three resizes of the served segmentation model, in other
dtypes (converted to float32 around the kernel, as around the plain passes)
and on the edges of the kernel's own plan (a row whose length is not a
multiple of 4 values, tiled rows).

On the CPU (a few seconds): CPU tensors take the plain version, and a
traced call records the op ``frostnet::resize_bilinear``, whose CPU
implementation is the plain version; on fake CUDA tensors a call with no
gradient launches directly and one whose gradient is recorded calls the op;
the op's gradient (the passes' transposes) equals autograd's through the
plain version bit for bit; the tap tables are built once per key; the
launch count moves only with a launch; the plan tiles a row where its input
span would not fit, and an emulation of the kernel's dataflow on its tables
and plan (tiles forced small) gives the plain version's bits.

On the card (marker ``cuda``; no JAX, so ``--noconftest`` runs it): the
kernel bit-exact at the sizes above in both ``align_corners`` settings, 3
launches a served segmentation forward with the logits equal to the plain
path's, the kernel under autograd with the plain path's gradient, an
exported program that launches it, and a CUDA graph that captures the
resize after its first call (no host copy is left in the call).
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from frostnet_tpu_torch import ops
from frostnet_tpu_torch.ops import resize
from frostnet_tpu_torch.ops.requant import fma_f32
from frostnet_tpu_torch.ops.resize import (_taps, resize_bilinear, resize_bilinear_plain,
                                           resize_plan, resize_tables)

# (n_in, n_out, channels, batch, XLA's form): the segmentation models' resizes
# (tests/test_torch_resize.py holds the plain version to JAX at each)
SEG_RESIZES = [(48, 96, 128, 2, "separate"), (96, 768, 19, 1, "fma"),      # crop 768, V3
               (6, 12, 128, 2, "separate"), (12, 96, 19, 2, "separate"),    # crop 96, V3
               (4, 8, 128, 2, "separate"), (8, 64, 19, 2, "fma"),           # crop 64, V3
               (48, 192, 128, 1, "fma"), (192, 768, 19, 1, "fma"),          # crop 768, V2
               (6, 24, 128, 2, "separate"), (24, 96, 19, 2, "separate"),    # crop 96, V2
               # crop 768: ESPNetv2 (s 2.0) PSP's four stages and proj_L4_C to
               # l3's 96, its decoder's 96 -> 192 and 192 -> 384 and the tail's
               # 384 -> 768; ESPNet's up2 96 -> 192 -> 384 and its tail's 384 -> 768
               (48, 96, 256, 1, "separate"), (24, 96, 256, 1, "separate"),
               (12, 96, 256, 1, "separate"), (6, 96, 256, 1, "separate"),
               (96, 192, 19, 1, "fma"), (192, 384, 19, 1, "fma"), (384, 768, 19, 1, "fma"),
               (96, 192, 20, 1, "fma"), (192, 384, 20, 1, "fma"), (384, 768, 20, 1, "fma")]
# the GAN's 2x resizes and 32 -> 64, (n, channels): n -> 2n
GAN_RESIZES = [(32, 16), (64, 8), (128, 4)]
# Tiny-DSOD's requant_up joins (align_corners=False), n -> m at 128 channels
DET_RESIZES = [(2, 3), (3, 5), (5, 10), (10, 19), (19, 38)]
# the served segmentation model's three resizes at the cell's batch 8 and
# 512x1024: the LR-ASPP gate, the head's c4 to c1, the tail to the image
SEG_CELL = [((8, 1, 3, 128), (32, 64)), ((8, 32, 64, 128), (64, 128)),
            ((8, 64, 128, 19), (512, 1024))]
# the kernel's own edges: rows of a length that is not a multiple of 4
# values, a row tiled for shared memory, downsampling, one output row
EDGES = [((2, 5, 7, 3), (9, 13)), ((1, 4, 96, 160), (8, 200)), ((2, 17, 33, 6), (5, 7)),
         ((1, 3, 5, 12), (1, 1)), ((1, 1, 1, 7), (4, 6))]


def _x(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3).to(dtype)


def _fake_cuda(shape, requires_grad=False):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return torch.empty(shape, device="cuda", requires_grad=requires_grad)


class _Resize(torch.nn.Module):
    def __init__(self, size):
        super().__init__()
        self.size = size

    def forward(self, x):
        return resize_bilinear(x, self.size)


def test_cpu_calls_take_the_plain_version_and_traced_calls_record_the_op():
    from torch.profiler import ProfilerActivity, profile

    from frostnet_tpu_torch.utils.profiling import session

    x = _x((2, 6, 5, 4), 1)
    before = resize_bilinear.launches
    with profile(activities=[ProfilerActivity.CPU]):
        got = resize_bilinear(x, (12, 64))
    assert session() == [] and resize_bilinear.launches == before
    assert torch.equal(got, resize_bilinear_plain(x, (12, 64)))
    xg = x.clone().requires_grad_(True)
    resize_bilinear(xg, (12, 64)).sum().backward()
    assert xg.grad is not None and resize_bilinear.launches == before

    prog = torch.export.export(_Resize((12, 64)), (x,))
    targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
    assert targets == {"frostnet.resize_bilinear.default"}
    assert torch.equal(prog.module()(x), got) and resize_bilinear.launches == before


def test_a_cuda_tensor_launches_directly_or_calls_the_op(monkeypatch):
    """Fake CUDA tensors (no card), the launch and the op stubbed: a traced
    call calls the op; past the trace check, a CUDA tensor with no gradient
    launches directly and one whose gradient is recorded calls the op."""
    launched, called = [], []
    monkeypatch.setattr(resize, "_launch", lambda x, *args: launched.append(args) or x)
    monkeypatch.setattr(torch.ops.frostnet, "resize_bilinear",
                        lambda x, *args: called.append(args) or x)
    x, xg = _fake_cuda((2, 4, 4, 3)), _fake_cuda((2, 4, 4, 3), requires_grad=True)
    resize_bilinear(x, (8, 6))
    assert called == [(8, 6, True)] and launched == []
    monkeypatch.setattr(resize.cuda_build, "traced", lambda t: False)
    resize_bilinear(x, (8, 6))
    assert launched == [(8, 6, True)] and len(called) == 1
    resize_bilinear(xg, (8, 6), align_corners=False)
    assert called == [(8, 6, True), (8, 6, False)] and len(launched) == 1
    with torch.no_grad():
        resize_bilinear(xg, (8, 6), align_corners=False)
    assert launched == [(8, 6, True), (8, 6, False)] and len(called) == 2
    assert resize_bilinear(x, (4, 4)) is x and len(launched) + len(called) == 4


# (input shape, size, align_corners, dtype): both forms of each pass, a
# broadcast, downsampling, a bfloat16 input
GRAD_CASES = [((2, 6, 5, 4), (12, 64), True, torch.float32),
              ((2, 8, 16, 19), (64, 128), True, torch.float32),
              ((1, 5, 7, 3), (9, 13), False, torch.float32),
              ((2, 1, 3, 7), (32, 64), True, torch.float32),
              ((1, 9, 12, 2), (4, 5), True, torch.float32),
              ((2, 3, 3, 5), (64, 6), True, torch.bfloat16)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "x".join(map(str, c[0] + c[1])))
def test_op_gradient_equals_autograd_through_the_plain_version(case):
    shape, size, ac, dtype = case
    x = _x(shape, sum(shape), dtype)
    g = _x((shape[0], *size, shape[3]), 3, dtype)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya = torch.ops.frostnet.resize_bilinear(a, *size, ac)
    ya.backward(g)
    yb = resize_bilinear_plain(b, size, ac)
    yb.backward(g)
    assert torch.equal(ya, yb) and a.grad.dtype == dtype
    assert torch.equal(_bits(a.grad), _bits(b.grad))


def test_tables_are_built_once_per_key(monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args)
        return _taps(*args)

    monkeypatch.setattr(resize, "_TABLES", {})
    monkeypatch.setattr(resize, "_taps", counted)
    t = resize_tables(64, 512, True, "cpu")
    assert resize_tables(64, 512, True, torch.device("cpu")) is t and len(calls) == 1
    assert resize_tables(64, 512, False, "cpu") is not t and len(calls) == 2
    assert resize_tables(3, 64, True, "cpu").shape == (4, 64) and len(calls) == 3
    lo, hi, w_lo, w_hi = _taps(64, 512, True)
    assert t.dtype == torch.int32 and t.shape == (4, 512)
    np.testing.assert_array_equal(t[0].numpy(), lo)
    np.testing.assert_array_equal(t[1].numpy(), hi)
    np.testing.assert_array_equal(t[2].numpy().view(np.float32), w_lo)
    np.testing.assert_array_equal(t[3].numpy().view(np.float32), w_hi)


def test_launch_count_moves_only_with_a_launch():
    """Plain calls and calls at the input's own size launch nothing (the
    card's tests count the launches)."""
    ops.reset_launch_counts()
    x = _x((1, 3, 3, 2), 2)
    resize_bilinear(x, (6, 6))
    assert resize_bilinear(x, (3, 3)) is x  # the same size: no work at all
    assert ops.launch_counts() == {"int8_matmul_requant": 0, "frost_block_int8": 0,
                                   "fake_quant_observe": 0, "int8_conv": 0,
                                   "depthwise_int8": 0, "resize_bilinear": 0}


def test_plan_keeps_whole_rows_and_tiles_wide_ones():
    # the seg cell's three W passes: whole rows (the tail's 128 x 19 line is 9.7 KB)
    assert resize_plan(3, 64, True, 128) == (64, 64 * 16 + 3 * 128 * 4)
    assert resize_plan(64, 128, True, 128) == (128, 128 * 16 + 64 * 128 * 4)
    assert resize_plan(128, 1024, True, 19) == (1024, 1024 * 16 + 128 * 19 * 4)
    tile, smem = resize_plan(96, 200, True, 160)  # a 61 KB line: tiled
    assert tile < 200 and smem <= resize.SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        resize_plan(8, 8, True, 7000)


def _emulate(x, size, align_corners):
    """The kernel's dataflow in torch ops: for each block (an output row and
    a tile of columns), the H pass of the tile's input span from the row
    taps, then the W pass from the column taps' offsets in that line."""
    b, h, w, c = x.shape
    h_out, w_out = size
    th = resize_tables(h, h_out, align_corners, "cpu")
    tw = resize_tables(w, w_out, align_corners, "cpu")
    tile, smem = resize_plan(w, w_out, align_corners, c)
    assert smem <= resize.SMEM_BYTES

    def lerp(wl, xl, wh, xh, fused):
        return fma_f32(xh, wh, xl * wl) if fused else xl * wl + xh * wh

    def weight(t, i):
        return t[2:, i].numpy().view(np.float32)

    out = torch.empty((b, h_out, w_out, c))
    x = x.to(torch.float32)
    for oy in range(h_out):
        ylo, yhi = int(th[0, oy]), int(th[1, oy])
        hwl, hwh = (torch.tensor(v) for v in weight(th, oy))
        for ox0 in range(0, w_out, tile):
            nx = min(tile, w_out - ox0)
            col0, col1 = int(tw[0, ox0]), int(tw[1, ox0 + nx - 1])
            assert 16 * nx + 4 * c * (col1 - col0 + 1) <= smem
            line = lerp(hwl, x[:, ylo, col0:col1 + 1], hwh, x[:, yhi, col0:col1 + 1],
                        h_out % 64 == 0)
            for ox in range(ox0, ox0 + nx):
                wl, wh = (torch.tensor(v) for v in weight(tw, ox))
                out[:, oy, ox] = lerp(wl, line[:, int(tw[0, ox]) - col0], wh,
                                      line[:, int(tw[1, ox]) - col0], w_out % 64 == 0)
    return out


@pytest.mark.parametrize("shape,size,ac", [((2, 5, 7, 3), (9, 128), True),
                                           ((1, 6, 40, 8), (5, 64), False),
                                           ((1, 4, 12, 5), (3, 30), True)])
def test_emulated_dataflow_gives_the_plain_bits(monkeypatch, shape, size, ac):
    monkeypatch.setattr(resize, "_PLANS", {})
    monkeypatch.setattr(resize, "SMEM_BYTES", 16 * 8 + 4 * shape[3] * 4)  # tiles of a few columns
    assert resize_plan(shape[2], size[1], ac, shape[3])[0] < size[1]
    x = _x(shape, sum(shape))
    assert torch.equal(_emulate(x, size, ac), resize_bilinear_plain(x, size, ac))


def _bits(t):
    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])


def _check(x, size, ac, dev):
    """The kernel on ``dev`` against the plain version on the card, bit for
    bit (the sign of a zero too)."""
    xd = x.to(dev)
    before = resize_bilinear.launches
    got = resize_bilinear(xd, size, ac)
    assert resize_bilinear.launches == before + 1
    want = resize_bilinear_plain(xd, size, ac)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("case", SEG_RESIZES, ids=lambda c: f"{c[0]}to{c[1]}x{c[2]}")
def test_kernel_bit_exact_at_the_seg_sizes(cuda_device, case, ac):
    n, n_out, c, b, _ = case
    _check(_x((b, n, n, c), n_out + c), (n_out, n_out), ac, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("ac", [True, False])
def test_kernel_bit_exact_at_the_gan_det_and_broadcast_sizes(cuda_device, ac):
    for n, c in GAN_RESIZES:
        _check(_x((2, n, n, c), n), (2 * n, 2 * n), ac, cuda_device)
    for n, m in DET_RESIZES:
        _check(_x((2, n, n, 128), m), (m, m), ac, cuda_device)
    for m in (4, 6, 12, 48):
        _check(_x((2, 1, 1, 128), 3), (m, m), ac, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("i", range(len(SEG_CELL)))
def test_kernel_bit_exact_at_the_seg_cell(cuda_device, i, ac):
    shape, size = SEG_CELL[i]
    _check(_x(shape, i), size, ac, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGES, ids=lambda c: "x".join(map(str, c[0] + c[1])))
def test_kernel_bit_exact_at_its_edges(cuda_device, case):
    shape, size = case
    for ac in (True, False):
        _check(_x(shape, 5), size, ac, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_kernel_bit_exact_in_other_dtypes(cuda_device, dtype):
    for shape, size in (((2, 8, 16, 19), (64, 128)), ((2, 5, 7, 3), (9, 13))):
        _check(_x(shape, 6, dtype), size, True, cuda_device)


@pytest.mark.cuda
def test_kernel_bit_exact_on_a_strided_input(cuda_device):
    x = _x((2, 16, 8, 19), 7).to(cuda_device).transpose(1, 2)
    assert not x.is_contiguous()
    got = resize_bilinear(x, (64, 128))
    assert torch.equal(got, resize_bilinear_plain(x, (64, 128)))


@pytest.mark.cuda
def test_autograd_takes_the_kernel_and_the_plain_gradient_on_the_card(cuda_device):
    """Under autograd the forward is the kernel's (one launch, the plain
    bits), the gradient the plain version's: the same ``index_add_`` calls,
    equal bit for bit under deterministic algorithms."""
    for shape, size, ac, dtype in GRAD_CASES:
        x = _x(shape, sum(shape), dtype).to(cuda_device)
        g = _x((shape[0], *size, shape[3]), 3, dtype).to(cuda_device)
        a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            before = resize_bilinear.launches
            ya = resize_bilinear(a, size, ac)
            assert resize_bilinear.launches == before + 1
            ya.backward(g)
            yb = resize_bilinear_plain(b, size, ac)
            yb.backward(g)
        finally:
            torch.use_deterministic_algorithms(False)
        assert resize_bilinear.launches == before + 1
        assert torch.equal(_bits(ya), _bits(yb)) and torch.equal(_bits(a.grad), _bits(b.grad))


@pytest.mark.cuda
def test_exported_program_launches_the_kernel(cuda_device):
    x = _x((2, 8, 16, 19), 11).to(cuda_device)
    prog = torch.export.export(_Resize((64, 128)), (x,))
    targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
    assert targets == {"frostnet.resize_bilinear.default"}
    before = resize_bilinear.launches
    got = prog.module()(x)
    assert resize_bilinear.launches == before + 1
    assert torch.equal(got, resize_bilinear_plain(x, (64, 128)))


@pytest.mark.cuda
def test_graph_captures_the_resize_after_its_first_call(cuda_device):
    """After the first call at its shapes the kernel path copies nothing
    from the host, so a CUDA graph captures it; the replay gives the plain
    version's bits."""
    x = _x((8, 64, 128, 19), 9).to(cuda_device)
    first = resize_bilinear(x, (512, 1024))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = resize_bilinear(x, (512, 1024))
    x.copy_(_x(x.shape, 10).to(cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, resize_bilinear_plain(x, (512, 1024)))
    assert not torch.equal(out, first)


@pytest.mark.cuda
def test_seg_forward_launches_and_equals_the_plain_path(cuda_device, tmp_path, monkeypatch):
    """3 launches a served segmentation forward (``mobilenetv3_large``, the
    committed fixture at 768x768: the LR-ASPP gate, the head, the tail), and
    the logits bit-equal to the forward whose resizes take the plain path."""
    from chip_smoke import seg_served_model

    _, fn = seg_served_model("mobilenetv3_large", cuda_device, str(tmp_path))
    images = np.random.RandomState(0).randn(2, 768, 768, 3).astype(np.float32)
    ops.reset_launch_counts()
    logits = fn(images)
    torch.cuda.synchronize()
    assert ops.launch_counts()["resize_bilinear"] == 3 and logits.device.type == "cuda"
    monkeypatch.setattr(resize, "resize_bilinear", resize_bilinear_plain)
    ops.reset_launch_counts()
    plain = fn(images)
    assert ops.launch_counts()["resize_bilinear"] == 0 and torch.equal(logits, plain)
