"""PyTorch port on the GPU: each CUDA kernel against its plain torch version.

Every test here needs a CUDA card and nvcc (marker ``cuda``) and skips on a
CPU-only host. The file imports no JAX, so on a GPU machine without JAX it
runs on its own:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

chip_smoke.py runs the same checks at every shape of the model's main path.
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from frostnet_tpu_torch import quant as tq
from frostnet_tpu_torch.nn import Observer
from frostnet_tpu_torch import ops
from frostnet_tpu_torch.ops import frost_block as tfb
from frostnet_tpu_torch.ops.fake_quant import (ObservedFakeQuant, fake_quant_observe,
                                               fake_quant_observe_plain)
from frostnet_tpu_torch.ops.int8_conv import (conv3x3_operands, conv3x3_s1_int8,
                                              conv3x3_s1_int8_plain)
from frostnet_tpu_torch.ops.int8_matmul import (conv1x1_operands, int8_matmul_requant,
                                                int8_matmul_requant_plain)

pytestmark = pytest.mark.cuda

# the model's shapes, then shapes that cut the kernel's tiles (64 or 128
# rows, 64, 128 or 256 columns, 128-byte K chunks): M=8 and 392, the stems'
# K=27 and 147 (rows not 16-byte aligned), K=1152 with N=256, N=1000
MATMUL_SHAPES = [(256, 136, 816), (100, 24, 144), (17, 8, 40),
                 (100352, 27, 32), (392, 320, 1280), (8, 1280, 1000),
                 (8, 27, 1000), (392, 576, 128), (5000, 147, 64), (4096, 1152, 256),
                 (1000, 40, 72), (17000, 576, 300),
                 # MobileNetV3's 1x1 convs at batch 8 whose K is not a multiple
                 # of 16 (rows not 16-byte aligned): K = 24, 40, 72, 88, 120,
                 # 184, 200; its head at M = 8
                 (25088, 24, 72), (6272, 72, 40), (6272, 40, 120), (6272, 120, 40),
                 (6272, 88, 24), (1568, 184, 80), (1568, 200, 80), (8, 960, 1280),
                 # qresnet50 at batch 8: layer1's 1x1s, a strided downsample,
                 # a strided 3x3 on the im2col route (K = 9 x 256), layer4's
                 # 1x1s on a 7x7 map
                 (25088, 64, 256), (25088, 256, 64), (6272, 256, 512), (1568, 2304, 256),
                 (392, 2048, 512), (392, 512, 2048)]

BLOCKS = [
    dict(h=14, w=14, cin=96, cout=96, kernel=5, stride=1, has_squeeze=True,
         has_expand=True, c_sq=24, c_e=360, residual=True),
    dict(h=28, w=28, cin=40, cout=80, kernel=5, stride=2, has_squeeze=True,
         has_expand=True, c_sq=16, c_e=336, residual=False),
    dict(h=56, w=56, cin=24, cout=24, kernel=3, stride=1, has_squeeze=False,
         has_expand=True, c_sq=0, c_e=144, residual=True),
    dict(h=32, w=32, cin=16, cout=16, kernel=3, stride=1, has_squeeze=False,
         has_expand=False, c_sq=0, c_e=16, residual=True),
    dict(h=14, w=14, cin=96, cout=96, kernel=5, stride=1, has_squeeze=True,
         has_expand=True, c_sq=24, c_e=360, residual=True, act_qmax=127),
    dict(h=7, w=7, cin=192, cout=320, kernel=5, stride=1, has_squeeze=True,
         has_expand=True, c_sq=96, c_e=1728, residual=False),
]
# shapes of frostnet_quant_large_1_0 that reach every cluster size the
# planner picks on an H100 (132 SMs): 7x7 E1440 (layer4_1) at batch 1, 3, 8
# (a cluster of 16) and 128 (2), on the fbgemm grid too; E720, which is not a
# multiple of 16 x 32 (layer4_3, 16); stride 2 k5 into 7x7 (layer4_0, 16); a
# 14x14 map as one tile (layer3_4 above, 8); 112x112 without expand
# (layer1_0, 1); 28x28 E168 at batch 1 (layer2_1, 4)
L4_1 = dict(h=7, w=7, cin=192, cout=192, kernel=5, stride=1, has_squeeze=True,
            has_expand=True, c_sq=48, c_e=1440, residual=True)
CLUSTER_BLOCKS = [(L4_1, 1), (L4_1, 3), (L4_1, 8), (L4_1, 128), ({**L4_1, "act_qmax": 127}, 8),
                  ({**L4_1, "c_e": 720}, 8),
                  (dict(h=14, w=14, cin=96, cout=192, kernel=5, stride=2, has_squeeze=True,
                        has_expand=True, c_sq=48, c_e=864, residual=False), 8),
                  (dict(h=112, w=112, cin=32, cout=16, kernel=3, stride=1, has_squeeze=False,
                        has_expand=False, c_sq=0, c_e=32, residual=False), 8),
                  (dict(h=28, w=28, cin=40, cout=40, kernel=3, stride=1, has_squeeze=True,
                        has_expand=True, c_sq=16, c_e=168, residual=True), 1)]
BLOCK_CASES = [(c, 8) for c in BLOCKS] + CLUSTER_BLOCKS


def _block_id(case):
    c, batch = case
    return (f"{c['h']}x{c['cin']}_e{c['c_e']}_k{c['kernel']}s{c['stride']}"
            + ("" if batch == 8 and c in BLOCKS else f"_q{c.get('act_qmax', 255)}_b{batch}"))


def _matmul_case(m, k, n, signed, qmax, device, seed=1):
    rng = np.random.RandomState(seed)
    lo, hi, dt = (-128, 128, np.int8) if signed else (0, qmax + 1, np.uint8)
    x = torch.as_tensor(rng.randint(lo, hi, (m, k)).astype(dt), device=device)
    # scales that spread each output over many codes (per channel on fbgemm)
    comb = rng.rand(n if qmax == 127 else 1).astype(np.float32) * 2e-4 + 1e-4
    op = conv1x1_operands(torch.as_tensor(rng.randint(-128, 128, (k, n)).astype(np.int8)),
                          torch.as_tensor(comb.reshape(-1) if qmax == 127 else comb[0]) /
                          np.sqrt(k),
                          torch.as_tensor(rng.randn(n).astype(np.float32)), 113, 0.02, 7,
                          not signed, 0, qmax, device)
    return x, op


@pytest.mark.parametrize("qmax", [255, 127], ids=["qnnpack", "fbgemm"])
@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_int8_matmul_kernel_matches_plain(cuda_device, m, k, n, signed, qmax):
    x, op = _matmul_case(m, k, n, signed, qmax, cuda_device)
    before = int8_matmul_requant.launches
    got = int8_matmul_requant(x, op)
    assert int8_matmul_requant.launches == before + 1
    want = int8_matmul_requant_plain(x, op)
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 16


def test_int8_matmul_kernel_relu6_clamp(cuda_device):
    """ReLU6 reaches the kernel as a narrower clamp [zp, q6] of the codes
    (``QConvBNAct.code_range``): MobileNetV2's head at batch 8."""
    x, op = _matmul_case(392, 320, 1280, False, 255, cuda_device, seed=3)
    op.qmin, op.qmax = 7, 181
    got, want = int8_matmul_requant(x, op), int8_matmul_requant_plain(x, op)
    assert torch.equal(got, want)
    assert int(want.min()) == 7 and int(want.max()) == 181 and len(torch.unique(want)) > 16


@pytest.mark.parametrize("name", ["qmobilenet_v2_ReLU", "qmobilenet_v3_large_HS"])
def test_mobilenet_predictor_launches(cuda_device, name, tmp_path):
    """The full-width MobileNet fixture served on the card: one matmul launch
    per 1x1 or im2col conv and nothing else, every layer's codes and the
    logits equal to the committed JAX reference (first two images)."""
    from chip_smoke import TESTDATA, code_digests, layer_codes, mobilenet_predictor
    from frostnet_tpu_torch.nn import QConvBNAct

    ref = np.load(f"{TESTDATA}/{name}_reference.npz")
    pred = mobilenet_predictor(name, cuda_device, str(tmp_path))
    n_mm = sum(getattr(m, "_route", None) in ("matmul", "im2col") for m in pred.model.modules()
               if isinstance(m, QConvBNAct))
    images = np.random.RandomState(0).randn(2, 224, 224, 3).astype(np.float32)
    ops.reset_launch_counts()
    logits, codes = layer_codes(pred, images)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"int8_matmul_requant": n_mm, "frost_block_int8": 0,
                                   "fake_quant_observe": 0, "int8_conv": 0}
    for k in ref.files:
        if k.startswith("sha256/"):
            assert code_digests(codes[k[7:]]) == list(ref[k][:2]), k
    assert np.array_equal(logits.cpu().numpy(), ref["logits"][:2])


@pytest.mark.parametrize("m,k,n", [(300, 64, 72), (130, 1152, 256), (77, 147, 64)])
def test_int8_matmul_kernel_unaligned_rows(cuda_device, m, k, n):
    """x one byte into its storage: no row is 16-byte aligned, so every K
    takes the kernel's aligned-word path."""
    x, op = _matmul_case(m, k, n, False, 255, cuda_device, seed=2)
    buf = torch.empty(m * k + 1, dtype=torch.uint8, device=cuda_device)
    xs = buf[1:].view(m, k)
    xs.copy_(x)
    assert xs.data_ptr() % 16 != 0
    assert torch.equal(int8_matmul_requant(xs, op), int8_matmul_requant_plain(x, op))


@pytest.mark.parametrize("case", BLOCK_CASES, ids=_block_id)
def test_frost_block_kernel_matches_plain(cuda_device, case):
    case, batch = case
    spec = tfb.FrostBlockSpec(**case)
    x, p = tfb.random_block_case(spec, batch, seed=3, device=cuda_device)
    before = tfb.frost_block_int8.launches
    got = tfb.frost_block_int8(x, p, spec)
    assert tfb.frost_block_int8.launches == before + 1
    want = tfb.frost_block_int8_plain(x, p, spec)
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 16


def test_frost_block_batches_share_packed_weights(cuda_device):
    """One block called at several batch sizes: a launch per batch, one
    packed copy of the weights per distinct ``pack_key``, each bit-exact."""
    spec = tfb.FrostBlockSpec(**L4_1)
    x, p = tfb.random_block_case(spec, 16, seed=4, device=cuda_device)
    for batch in (1, 2, 8, 16):
        assert torch.equal(tfb.frost_block_int8(x[:batch], p, spec),
                           tfb.frost_block_int8_plain(x[:batch], p, spec))
    keys = {launch.plan.pack_key for launch in p.launches.values()}
    assert sorted(p.launches) == [1, 2, 8, 16] and len(keys) < 4
    assert set(p.packed) == keys | {"head"}
    for launch in p.launches.values():
        assert launch.stages is p.packed[launch.plan.pack_key] and launch.head is p.packed["head"]


# (shape, scale of the values, observer state before: None = fresh). The
# kernel's two launch shapes (ops/fake_quant.py plan_fake_quant): one cluster
# for x up to 16 x 16 KiB (the small shapes; (16, 4096) float32 is the
# largest cluster, (65537,) one element past it), else a grid of one CUDA
# block an SM, whose shared memory holds all of x up to ~26 MiB
# ((8, 112, 112, 32), (8, 56, 56, 144)) and part of it above
# ((128, 56, 56, 144) float32 is 220 MiB)
FQ_CASES = [((8, 112, 112, 32), 3.0, None), ((8, 56, 56, 144), 1.0, (-0.5, 2.0)),
            ((3, 3, 1, 720), 0.1, (-0.2, 0.3)), ((8, 1, 1, 1000), 20.0, (-30.0, 20.0)),
            ((7, 13), 1.0, None), ((1,), 1.0, (0.0, 1.0)), ((16, 4096), 2.0, (-1.0, 3.0)),
            ((65537,), 2.0, None), ((128, 56, 56, 144), 1.0, (-0.5, 2.0)),
            # MobileNetV3 sites: QDense weights (C, F) and outputs (N, F), the
            # squeeze-excite gate (N, 1, 1, C), 5x5 depthwise weights, a
            # hard-swish's ReLU6 over the stem's map
            ((960, 240), 0.05, (-0.1, 0.1)), ((8, 240), 3.0, None), ((8, 1, 1, 960), 0.5, None),
            ((5, 5, 1, 672), 0.2, (-0.3, 0.3)), ((8, 112, 112, 16), 2.0, (0.0, 6.0))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("spec", ["qnnpack_act", "qnnpack_weight", "fbgemm_act"])
@pytest.mark.parametrize("case", FQ_CASES, ids=lambda c: "x".join(map(str, c[0])))
def test_fake_quant_kernel_matches_plain(cuda_device, case, spec, dtype):
    shape, mag, st = case
    tspec = {"qnnpack_act": tq.QNNPACK_ACT, "qnnpack_weight": tq.QNNPACK_WEIGHT,
             "fbgemm_act": tq.FBGEMM_ACT}[spec]
    g = torch.Generator(device=cuda_device).manual_seed(len(shape))
    x = (torch.randn(shape, generator=g, device=cuda_device) * mag).to(dtype)
    mn, mx = (float("inf"), float("-inf")) if st is None else st
    mn, mx = torch.tensor(mn, device=cuda_device), torch.tensor(mx, device=cuda_device)
    kmin, kmax = mn.clone(), mx.clone()
    before = fake_quant_observe.launches
    y, mask, qp = fake_quant_observe(x, kmin, kmax, tspec)
    assert fake_quant_observe.launches == before + 1
    py, pmask, pst, ps, pz = fake_quant_observe_plain(x, tq.ObserverState(mn, mx), tspec)
    assert y.dtype == dtype and torch.equal(y, py) and torch.equal(mask, pmask)
    assert torch.equal(kmin, pst.min_val) and torch.equal(kmax, pst.max_val)
    assert float(qp[0]) == float(ps) and float(qp[1]) == float(pz)
    y2, m2, none = fake_quant_observe(x, kmin, kmax, tspec, observe=False)
    assert none is None and fake_quant_observe.launches == before + 2
    py2, pm2, _, _, _ = fake_quant_observe_plain(x, pst, tspec, observe=False)
    assert torch.equal(y2, py2) and torch.equal(m2, pm2)
    if x.numel() > 1:  # a view one element in takes the unaligned path
        xs = x.reshape(-1)[1:]
        ys, ms, _ = fake_quant_observe(xs, kmin.clone(), kmax.clone(), tspec)
        pys, pms, _, _, _ = fake_quant_observe_plain(xs, pst, tspec)
        assert torch.equal(ys, pys) and torch.equal(ms, pms)


@pytest.mark.parametrize("shape", [(4, 7, 7, 96), (128, 28, 28, 144)],
                         ids=["cluster", "grid"])
def test_fake_quant_graph_replay(cuda_device, shape):
    """One observing site captured in a CUDA graph and replayed twice
    equals the plain version applied twice: the grid shape's barrier and
    partials are left ready for the next launch, the state is stepped in
    place each replay."""
    from frostnet_tpu_torch.ops.fake_quant import plan_fake_quant

    spec = tq.QNNPACK_ACT
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5
    plan = plan_fake_quant(x.numel(), 4, True, torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    assert plan.cluster == (shape[0] == 4)
    st = tq.ObserverState(torch.tensor(-1.0, device=cuda_device),
                          torch.tensor(1.5, device=cuda_device))
    fake_quant_observe(x, st.min_val.clone(), st.max_val.clone(), spec)  # build, plan, scratch
    kmin, kmax = st.min_val.clone(), st.max_val.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, mask, qp = fake_quant_observe(x, kmin, kmax, spec)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        py, pmask, st, ps, pz = fake_quant_observe_plain(x, st, spec)
        assert torch.equal(y, py) and torch.equal(mask, pmask)
        assert torch.equal(kmin, st.min_val) and torch.equal(kmax, st.max_val)
        assert float(qp[0]) == float(ps) and float(qp[1]) == float(pz)
    assert (~mask).any() and mask.any()


def test_fake_quant_ste_gradient(cuda_device):
    x = torch.randn(8, 28, 28, 40, device=cuda_device) * 2
    obs = Observer().to(cuda_device)
    obs.min_val.fill_(-1.0)
    obs.max_val.fill_(1.5)
    st = obs.state()
    xg = x.clone().requires_grad_(True)
    g = torch.randn_like(x)
    ObservedFakeQuant.apply(xg, obs, tq.QNNPACK_ACT, True).backward(g)
    _, mask, _, _, _ = fake_quant_observe_plain(
        x, tq.ObserverState(st.min_val.to(cuda_device), st.max_val.to(cuda_device)),
        tq.QNNPACK_ACT)
    assert torch.equal(xg.grad, torch.where(mask, g, torch.zeros((), device=cuda_device)))
    assert (~mask).any() and mask.any()


# (H, W, Cin, Cout) of the GAN generator's 20 dense 3x3 convs (18 block convs,
# up0, up1), and ragged shapes for the kernel's edge tiles (4 rows x 64
# columns x 64 or 128 channels, 32-channel chunks; 16-byte loads only where
# Cin is a multiple of 16): W and Cout past a tile, Cin not a multiple of 32
CONV_SHAPES = [(64, 64, 256, 256), (128, 128, 256, 128), (256, 256, 128, 64), (13, 21, 68, 36),
               (37, 75, 68, 132), (6, 70, 48, 52), (9, 130, 100, 200),
               # the ResNets' four stages: most of a 4 x 64 tile masked at
               # 14x14 and 7x7, Cin = 512 in 16 chunks
               (56, 56, 64, 64), (28, 28, 128, 128), (14, 14, 256, 256), (7, 7, 512, 512)]


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("qmax", [255, 127], ids=["qnnpack", "fbgemm"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "{}x{}_{}to{}".format(*s))
def test_int8_conv_kernel_matches_plain(cuda_device, shape, qmax, relu):
    h, w, cin, cout = shape
    g = torch.Generator().manual_seed(h + cin)
    x = torch.randint(0, qmax + 1, (2, h, w, cin), generator=g, dtype=torch.uint8)
    qw = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
    comb = torch.tensor(2e-5) if qmax == 255 else torch.rand(cout, generator=g) * 2e-5 + 1e-5
    op = conv3x3_operands(qw, comb, torch.randn(cout, generator=g) * 0.1, 91, 0.03, 11, relu,
                          0, qmax, cuda_device)
    x = x.to(cuda_device)
    before = conv3x3_s1_int8.launches
    got = conv3x3_s1_int8(x, op)
    assert conv3x3_s1_int8.launches == before + 1
    want = conv3x3_s1_int8_plain(x, op)
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 32


def test_gan_predictor_launches(cuda_device):
    """The committed GAN fixture served with cuDNN's TF32 at its default
    (allowed): the float tail turns it off itself, so the output stays
    within the CPU band (3e-5 after tanh) of the committed JAX output; a
    TF32 tail misses it by ~1.7e-3 (emulated on the CPU)."""
    from chip_smoke import GAN_ARTIFACT, GAN_REFERENCE, GAN_TAIL_BAND, gan_images
    from frostnet_tpu_torch.serve import GanPredictor

    ref = np.load(GAN_REFERENCE)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # cuDNN's default
    try:
        pred = GanPredictor(artifact=GAN_ARTIFACT, device=cuda_device)
        ops.reset_launch_counts()
        out = pred(gan_images(int(ref["image_seed"]), 4))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert ops.launch_counts() == {"int8_matmul_requant": 3, "frost_block_int8": 0,
                                   "fake_quant_observe": 0, "int8_conv": 20}
    assert out.shape == (4, 256, 256, 3) and bool(torch.isfinite(out).all())
    want = ref["output"]
    assert float(np.abs(out[:len(want)].cpu().numpy() - want).max()) <= GAN_TAIL_BAND


@pytest.mark.parametrize("name", ["qresnet18", "qresnet50"])
def test_resnet_predictor_launches(cuda_device, name, tmp_path):
    """The full-width ResNet fixture served on the card: 13 dense conv
    launches and one matmul launch per 1x1, strided 1x1 or im2col conv
    (7 / 40), nothing else; every layer's codes and the logits equal to the
    committed JAX reference (first two images)."""
    from chip_smoke import TESTDATA, code_digests, layer_codes, mobilenet_predictor

    ref = np.load(f"{TESTDATA}/{name}_reference.npz")
    pred = mobilenet_predictor(name, cuda_device, str(tmp_path))
    images = np.random.RandomState(0).randn(2, 224, 224, 3).astype(np.float32)
    ops.reset_launch_counts()
    logits, codes = layer_codes(pred, images)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"int8_matmul_requant": 7 if name == "qresnet18" else 40,
                                   "frost_block_int8": 0, "fake_quant_observe": 0,
                                   "int8_conv": 13}
    for k in ref.files:
        if k.startswith("sha256/"):
            assert code_digests(codes[k[7:]]) == list(ref[k][:2]), k
    assert np.array_equal(logits.cpu().numpy(), ref["logits"][:2])


@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_route_and_max_pool_match_cpu(cuda_device, stride):
    """ResNeXt's grouped INT8 route (torch ops: a float64 conv rounded to the
    int32 sum, then the epilogue) and the INT8 max pool give the same codes
    on the card as on the CPU."""
    from frostnet_tpu_torch.nn import INT8, QConvBNAct, max_pool
    from frostnet_tpu_torch.quant import QParams, QTensor

    g = torch.Generator().manual_seed(stride)
    conv = QConvBNAct(256, 256, 3, strides=stride, padding=1, groups=32)
    with torch.no_grad():
        conv.kernel.copy_(torch.randn(conv.kernel.shape, generator=g) * 0.1)
        conv.bias_bn.copy_(torch.randn(256, generator=g) * 0.2)
        conv.w_obs.min_val.fill_(-0.4)
        conv.w_obs.max_val.fill_(0.4)
        conv.act_obs.min_val.fill_(0.0)
        conv.act_obs.max_val.fill_(3.0)
    x = torch.randint(0, 256, (2, 28, 28, 256), generator=g, dtype=torch.uint8)
    grid = QParams(0.02, 100)
    outs = []
    for dev in ("cpu", cuda_device):
        conv.to(dev).eval()
        conv.prepare_int8(grid, dev)
        xq = QTensor(x.to(dev), *grid.tensors(dev))
        y = conv(xq, mode=INT8)
        pooled = max_pool(y, 3, 2, padding=1, zero_point=conv._out.zero_point)
        outs.append((y.q.cpu(), pooled.q.cpu()))
    assert conv._route == "grouped"
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert len(torch.unique(outs[0][0])) > 32


# the segmentation path at the Cityscapes crop of 768: the im2col stem at
# batch 2 and 16 (M = B x 384 x 384, K = 27 in rows padded to 32), the
# LR-ASPP gate's b1_conv at M = B (K = 288 and 480), 1x1s whose K is not a
# multiple of 16 on the 96x96 and 48x48 maps
SEG_MATMUL_SHAPES = [(294912, 27, 16), (2359296, 27, 16), (2, 288, 128), (16, 480, 128),
                     (147456, 24, 88), (36864, 40, 120), (36864, 120, 48)]


@pytest.mark.parametrize("m,k,n", SEG_MATMUL_SHAPES)
def test_int8_matmul_kernel_seg_shapes(cuda_device, m, k, n):
    x, op = _matmul_case(m, k, n, False, 255, cuda_device, seed=4)
    assert torch.equal(int8_matmul_requant(x, op), int8_matmul_requant_plain(x, op))


@pytest.mark.parametrize("shape", [(16, 384, 384, 16), (16, 768, 768, 3)],
                         ids=["stem_out", "input_stub"])
def test_fake_quant_kernel_seg_largest_sites(cuda_device, shape):
    """The segmentation trainer's largest QAT sites at batch 16 (151 MB and
    113 MB of float32: the cooperative-grid launch, x read twice)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda_device) * 2.0
    mn, mx = torch.tensor(-1.5, device=cuda_device), torch.tensor(2.5, device=cuda_device)
    spec = tq.QNNPACK.activation
    kmin, kmax = mn.clone(), mx.clone()
    y, mask, qp = fake_quant_observe(x, kmin, kmax, spec, observe=True)
    py, pmask, pst, ps, pz = fake_quant_observe_plain(x, tq.ObserverState(mn, mx), spec, True)
    assert torch.equal(y, py) and torch.equal(mask, pmask)
    assert torch.equal(kmin, pst.min_val) and torch.equal(kmax, pst.max_val)
    assert torch.equal(qp[0], ps) and torch.equal(qp[1], pz.to(torch.float32))


@pytest.mark.parametrize("name", ["mobilenetv3_RE_small", "mobilenetv3_large"])
def test_seg_fixture_served_on_the_card(cuda_device, name, tmp_path):
    """The full-width segmentation fixture (768x768) served on the card: one
    matmul launch per 1x1 or im2col conv and nothing else; every layer's
    codes equal to the committed JAX digests, the sampled logits and the
    argmax within the bands of ``tests/test_torch_seg_fixture.py`` (first
    image)."""
    from chip_smoke import seg_layer_codes, seg_served_model
    from frostnet_tpu_torch.nn import QConvBNAct
    from test_torch_seg_fixture import check_against_reference

    model, fn = seg_served_model(name, cuda_device, str(tmp_path))
    n_mm = sum(getattr(m, "_route", None) in ("matmul", "im2col") for m in model.modules()
               if isinstance(m, QConvBNAct))
    images = np.random.RandomState(0).randn(1, 768, 768, 3).astype(np.float32)
    ops.reset_launch_counts()
    logits, codes = seg_layer_codes(model, fn, images)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"int8_matmul_requant": n_mm, "frost_block_int8": 0,
                                   "fake_quant_observe": 0, "int8_conv": 0}
    check_against_reference(name, model, logits, codes, 1)


@pytest.mark.parametrize("k", [3, 5])
def test_dilated_depthwise_route_matches_cpu(cuda_device, k):
    """The dilated INT8 depthwise route (torch ops, dilation 2) gives the
    same codes on the card as on the CPU."""
    from frostnet_tpu_torch.nn import INT8, QConvBNAct
    from frostnet_tpu_torch.quant import QParams, QTensor

    g = torch.Generator().manual_seed(k)
    conv = QConvBNAct(96, 96, k, padding=k - 1, dilation=2, groups=96, act="relu")
    with torch.no_grad():
        conv.kernel.copy_(torch.randn(conv.kernel.shape, generator=g) * 0.3)
        conv.bias_bn.copy_(torch.randn(96, generator=g) * 0.2)
        conv.w_obs.min_val.fill_(-0.8)
        conv.w_obs.max_val.fill_(0.8)
        conv.act_obs.min_val.fill_(0.0)
        conv.act_obs.max_val.fill_(3.0)
    x = torch.randint(0, 256, (2, 48, 48, 96), generator=g, dtype=torch.uint8)
    grid = QParams(0.02, 100)
    outs = []
    for dev in ("cpu", cuda_device):
        conv.to(dev).eval()
        conv.prepare_int8(grid, dev)
        outs.append(conv(QTensor(x.to(dev), *grid.tensors(dev)), mode=INT8).q.cpu())
    assert conv._route == "depthwise" and torch.equal(outs[0], outs[1])
    assert len(torch.unique(outs[0])) > 32


# the detection path at 300x300: the im2col stems (qssd's 3 -> 32 and
# Tiny-DSOD's base1 3 -> 64, K = 27 in rows padded to 32) at batch 2 and 32,
# final_conv 320 -> 1280 and the first extra 1280 -> 32 on the 19x19 map,
# the later extras' 128 -> 32 on 10x10 and 5x5 at batch 2
DET_MATMUL_SHAPES = [(45000, 27, 32), (720000, 27, 32), (45000, 27, 64), (722, 320, 1280),
                     (722, 1280, 32), (200, 128, 32), (50, 128, 32)]


@pytest.mark.parametrize("m,k,n", DET_MATMUL_SHAPES)
def test_int8_matmul_kernel_det_shapes(cuda_device, m, k, n):
    x, op = _matmul_case(m, k, n, False, 255, cuda_device, seed=6)
    assert torch.equal(int8_matmul_requant(x, op), int8_matmul_requant_plain(x, op))


@pytest.mark.parametrize("net", ["qssd", "qtdsod"])
def test_det_fixture_served_on_the_card(cuda_device, net, tmp_path):
    """The full-width detection fixture (300x300) served on the card through
    ``serve.DetPredictor``: one matmul launch per 1x1 or im2col conv and
    nothing else; every layer's codes and each source equal to the
    committed JAX digests; loc, conf and the kept boxes within the bands of
    ``tests/test_torch_det_fixture.py`` (first image)."""
    from chip_smoke import (TESTDATA, check_det_layers, det_layer_codes, det_outputs_check,
                            det_served)
    from frostnet_tpu_torch.nn import QConvBNAct

    pred = det_served(net, cuda_device, str(tmp_path))
    n_mm = sum(getattr(m, "_route", None) in ("matmul", "im2col") for m in pred.feat.modules()
               if isinstance(m, QConvBNAct))
    images = np.random.RandomState(0).randn(1, 300, 300, 3).astype(np.float32)
    ops.reset_launch_counts()
    (loc, conf), sources, codes = det_layer_codes(pred, images)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"int8_matmul_requant": n_mm, "frost_block_int8": 0,
                                   "fake_quant_observe": 0, "int8_conv": 0}
    ref = np.load(f"{TESTDATA}/det_{net}_reference.npz")
    check_det_layers(net, codes, sources, ref)
    det_outputs_check(net, loc, conf, pred.priors, ref)


def test_channel_multiplier_depthwise_matches_cpu(cuda_device):
    """The SSD extras' INT8 depthwise conv with a channel multiplier (32 ->
    128, stride 2; torch ops) gives the same codes on the card as on the
    CPU."""
    from frostnet_tpu_torch.nn import INT8, QConvBNAct
    from frostnet_tpu_torch.quant import QParams, QTensor

    g = torch.Generator().manual_seed(7)
    conv = QConvBNAct(32, 128, 3, strides=2, padding=1, groups=32, act=None)
    with torch.no_grad():
        conv.kernel.copy_(torch.randn(conv.kernel.shape, generator=g) * 0.3)
        conv.bias_bn.copy_(torch.randn(128, generator=g) * 0.2)
        conv.w_obs.min_val.fill_(-0.8)
        conv.w_obs.max_val.fill_(0.8)
        conv.act_obs.min_val.fill_(-2.0)
        conv.act_obs.max_val.fill_(3.0)
    x = torch.randint(0, 256, (8, 19, 19, 32), generator=g, dtype=torch.uint8)
    grid = QParams(0.02, 100)
    outs = []
    for dev in ("cpu", cuda_device):
        conv.to(dev).eval()
        conv.prepare_int8(grid, dev)
        outs.append(conv(QTensor(x.to(dev), *grid.tensors(dev)), mode=INT8).q.cpu())
    assert conv._route == "depthwise" and torch.equal(outs[0], outs[1])
    assert outs[0].shape == (8, 10, 10, 128) and len(torch.unique(outs[0])) > 32
