"""GPU smoke run of the PyTorch port: build, check and time its kernels, serve.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure, and any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from ``frostnet_tpu_torch/csrc``
     (one nvcc per source, started together);
  3. hold each kernel against its plain torch version on the card, bit-exact:
     the 18 Frost-block shapes of frostnet_quant_large_1_0 at 224x224, batch 8,
     for qnnpack and fbgemm, and every INT8 matmul of the fused and unfused
     forwards (on the inputs those forwards give it, and with an fbgemm grid);
  4. the main path: serve the committed artifact through ``Int8Predictor``
     fused and unfused; the codes of every layer (QuantStub, stem, the 18
     blocks, last_layer, pool) must match the committed digests of the JAX
     ``freeze()`` codes, the logits must equal the committed JAX logits bit
     for bit, and the launch counts must be 18 blocks + 3 matmuls (fused)
     and 52 matmuls (unfused) per forward;
  5. ``serve.main`` for 20 iterations;
  6. timings with CUDA events: each kernel at its main-path shapes beside its
     bound, its plain version and ``torch._int_mm`` (GEMM only, where its
     shape rules allow), and images/s at batch 8 and 128, fused and unfused
     (whose logits must agree at both batches).
It prints a ``kernels`` JSON line, the card line, and last the device JSON.
Details go to ``build/chip_smoke.json`` (``--out`` puts them elsewhere).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from frostnet_tpu_torch import ops
from frostnet_tpu_torch.models import CascadePreExBottleneck, create_model
from frostnet_tpu_torch.nn import QConvBNAct
from frostnet_tpu_torch.ops import cuda_build
from frostnet_tpu_torch.ops.frost_block import (frost_block_int8, frost_block_int8_plain,
                                                random_block_case)
from frostnet_tpu_torch.ops.int8_matmul import (conv1x1_operands, int8_matmul_requant,
                                                int8_matmul_requant_plain)
from frostnet_tpu_torch.quant import get_qconfig
from frostnet_tpu_torch.serve import Int8Predictor
from frostnet_tpu_torch import serve

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(ROOT, "frostnet_tpu_torch", "testdata")
MODEL = "frostnet_quant_large_1_0"
ARTIFACT = os.path.join(TESTDATA, f"{MODEL}_int8.npz")
REFERENCE = os.path.join(TESTDATA, f"{MODEL}_reference.npz")
IMAGE, BATCH = 224, 8
# H100 SXM, dense: HBM rate and int8 tensor-core rate (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
BLOCK_SOURCE = "frostnet_tpu_torch/csrc/frost_block.cu"
MATMUL_SOURCE = "frostnet_tpu_torch/csrc/int8_matmul.cu"
BLOCK_REPLACES = "frostnet_tpu/ops/pallas_frost_block.py:354"
MATMUL_REPLACES = "frostnet_tpu/ops/pallas_int8_matmul.py:42"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def matmul_cost(m, k, n):
    # x read once, weight once, zterm/scale/bias vectors, uint8 out written once
    return m * k + k * n + 12 * n + m * n, 2.0 * m * n * k


def block_cost(spec, batch):
    ho, wo = spec.out_hw
    k2, e = spec.kernel ** 2, spec.c_e
    ccat = spec.c_sq + spec.cin if spec.has_squeeze else spec.cin
    weights = spec.cin * spec.c_sq + (ccat * e if spec.has_expand else 0) + k2 * e + e * spec.cout
    vectors = 12 * (spec.c_sq + (e if spec.has_expand else 0) + e + spec.cout)
    nbytes = batch * (spec.h * spec.w * spec.cin + ho * wo * spec.cout) + weights + vectors
    pix, opix = batch * spec.h * spec.w, batch * ho * wo
    nops = 2.0 * (pix * spec.cin * spec.c_sq + (pix * ccat * e if spec.has_expand else 0)
                  + opix * e * k2 + opix * e * spec.cout)
    return nbytes, nops


def capture(model, images):
    """The kernel inputs of one forward: conv matmul operands and block inputs."""
    calls, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, QConvBNAct) or (isinstance(mod, CascadePreExBottleneck)
                                           and mod.fuse_int8):
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, name=name: calls.append((name, m, args[0]))))
    with torch.inference_mode():
        model(images)
    for h in hooks:
        h.remove()
    return calls


def layer_codes(pred, images):
    """(logits, {layer: codes}) of one ``pred(images)`` call: the outputs of
    the model's top-level modules and, as ``pool``, the classifier's input.
    The hooks only keep references, so the call's launches are unchanged."""
    codes, hooks = {}, []

    def keep(name):
        def hook(mod, args, out):
            codes["pool" if name == "classifier" else name] = (args[0] if name == "classifier"
                                                               else out).q
        return hook

    for name, mod in pred.model.named_children():
        hooks.append(mod.register_forward_hook(keep(name)))
    try:
        logits = pred(images)
    finally:
        for h in hooks:
            h.remove()
    return logits, codes


def code_digests(codes: torch.Tensor):
    """SHA-256 hex digest of each image's uint8 NHWC codes."""
    arr = np.ascontiguousarray(codes.cpu().numpy())
    return [hashlib.sha256(c.tobytes()).hexdigest() for c in arr]


def check_layers(what, codes, ref):
    layers = [k[len("sha256/"):] for k in ref.files if k.startswith("sha256/")]
    bad = []
    for layer in layers:
        got = codes.get(layer)
        if got is None or tuple(got.shape) != tuple(ref[f"shape/{layer}"]):
            bad.append(f"{layer} (shape {None if got is None else tuple(got.shape)})")
            continue
        images = [i for i, (g, w) in enumerate(zip(code_digests(got), ref[f"sha256/{layer}"]))
                  if g != w]
        if images:
            bad.append(f"{layer} (images {images})")
    if bad:
        raise AssertionError(f"{what}: codes differ from the JAX reference at " + ", ".join(bad))
    return layers


def check_equal(what, got, want):
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel != plain version "
                             f"({int((got != want).sum())} codes differ, max abs err {err})")
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}

    # 1. the card
    card = card_line()
    report["card"] = card
    log(f"[card] {card}")

    # 2. build
    t0 = time.perf_counter()
    cuda_build.build(cuda_build.SOURCES)
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {cuda_build.SOURCES} in {report['build_s']:.1f} s")
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # 3a. the block kernel at the 18 main-path shapes, qnnpack and fbgemm
    max_err = {"frost_block_int8": 0, "int8_matmul_requant": 0}
    block_specs = {}
    for backend in ("qnnpack", "fbgemm"):
        net = create_model(MODEL, qconfig=get_qconfig(backend))
        block_specs[backend] = net.block_specs(IMAGE)
        for i, (name, spec) in enumerate(block_specs[backend]):
            x, p = random_block_case(spec, BATCH, seed=i, device=dev)
            err = check_equal(f"{backend} {name}", frost_block_int8(x, p, spec),
                              frost_block_int8_plain(x, p, spec))
            max_err["frost_block_int8"] = max(max_err["frost_block_int8"], err)
        log(f"[check] frost_block_int8 == plain at {len(block_specs[backend])} shapes "
            f"({backend}, batch {BATCH})")

    # 3b. fixture models, fused and unfused: every kernel input of one forward
    images = np.random.RandomState(0).randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    x_dev = torch.as_tensor(images, device=dev)
    preds = {fuse: Int8Predictor(MODEL, artifact=ARTIFACT, image_size=IMAGE,
                                 fuse_int8=fuse, device=dev) for fuse in (True, False)}
    mm_shapes = {}
    for fuse, pred in preds.items():
        calls = capture(pred.model, x_dev)
        shapes = []
        for name, mod, inp in calls:
            if isinstance(mod, CascadePreExBottleneck):
                err = check_equal(f"{name} (fixture)",
                                  frost_block_int8(inp.q, mod._params, mod._spec,
                                                   mod._plan, mod._args),
                                  frost_block_int8_plain(inp.q, mod._params, mod._spec))
                max_err["frost_block_int8"] = max(max_err["frost_block_int8"], err)
            elif mod._route in ("matmul", "im2col"):
                a = mod.matmul_input(inp.q)
                a = a.reshape(-1, a.shape[-1]).contiguous()
                err = check_equal(f"{name} (fixture)", int8_matmul_requant(a, mod._op),
                                  int8_matmul_requant_plain(a, mod._op))
                # the same shape on the fbgemm grid: per-channel scales, qmax 127
                g = torch.Generator().manual_seed(len(shapes))
                op = mod._op
                fb = conv1x1_operands(
                    op.wt[:, :op.k].t().cpu(), torch.rand(op.n, generator=g) * 1e-3 + 1e-4,
                    torch.randn(op.n, generator=g) * 0.05, 60, 0.021, 17, op.relu, 0, 127, dev)
                a127 = torch.randint(0, 128, a.shape, generator=g, dtype=torch.uint8).to(dev)
                err = max(err, check_equal(f"{name} (fbgemm grid)",
                                           int8_matmul_requant(a127, fb),
                                           int8_matmul_requant_plain(a127, fb)))
                max_err["int8_matmul_requant"] = max(max_err["int8_matmul_requant"], err)
                shapes.append((name, a, op))
        mm_shapes[fuse] = shapes
        log(f"[check] fixture {'fused' if fuse else 'unfused'}: "
            f"{sum(isinstance(m, CascadePreExBottleneck) for _, m, _ in calls)} block and "
            f"{len(shapes)} matmul inputs == plain")

    # 4. the main path: fused serving of the artifact, then the unfused one
    ref = np.load(REFERENCE)
    want = torch.as_tensor(ref["logits"])
    if len(torch.unique(want)) <= 128 or len(set(want.argmax(1).tolist())) < 2:
        raise AssertionError("the committed reference logits are too uniform to check much")
    logits, counts = {}, {}
    for fuse in (True, False):
        what = "fused" if fuse else "unfused"
        ops.reset_launch_counts()
        out, codes = layer_codes(preds[fuse], images)
        torch.cuda.synchronize()
        counts[fuse] = ops.launch_counts()
        logits[fuse] = out.cpu()
        layers = check_layers(what, codes, ref)
        log(f"[serve] {what} launches per forward: {counts[fuse]}; codes == JAX reference "
            f"at {len(layers)} layers x {BATCH} images")
    expect = {True: {"frost_block_int8": 18, "int8_matmul_requant": 3},
              False: {"frost_block_int8": 0, "int8_matmul_requant": 52}}
    for fuse in (True, False):
        if counts[fuse] != expect[fuse]:
            raise AssertionError(f"launch counts {counts[fuse]} != {expect[fuse]}")
        lg = logits[fuse]
        if lg.shape != (BATCH, 1000) or not torch.isfinite(lg).all():
            raise AssertionError(f"bad logits {tuple(lg.shape)}")
        if not torch.equal(lg, want):
            raise AssertionError(f"{'fused' if fuse else 'unfused'} logits != JAX logits "
                                 f"(max abs diff {float((lg - want).abs().max())})")
    log("[serve] fused == unfused == committed JAX freeze() logits, bit for bit; "
        f"{len(torch.unique(want))} distinct values, argmax {logits[True].argmax(1).tolist()}")

    # 5. the serve CLI
    rep = serve.main(serve.build_parser().parse_args(
        ["--artifact", ARTIFACT, "--iters", "20", "--fuse_int8"]))
    report["serve_main"] = rep

    # 6. timings
    timing = {"frost_block_int8": [], "int8_matmul_requant": []}
    for name, spec in block_specs["qnnpack"]:
        x, p = random_block_case(spec, BATCH, seed=0, device=dev)
        ms = time_ms(lambda: frost_block_int8(x, p, spec), reps=50)
        plain_ms = time_ms(lambda: frost_block_int8_plain(x, p, spec), reps=3, warmup=1)
        b_ms, b_by = bound(*block_cost(spec, BATCH))
        timing["frost_block_int8"].append(dict(shape=name, ms=ms, plain_ms=plain_ms,
                                               bound_ms=b_ms, bound_by=b_by, library_ms=None))
        log(f"[time] frost_block_int8 {name} {spec.h}x{spec.w}x{spec.cin}->{spec.cout} "
            f"E={spec.c_e} k{spec.kernel}s{spec.stride}: {ms:.4f} ms (bound {b_ms:.4f} "
            f"{b_by}, plain {plain_ms:.3f})")
    for fuse in (True, False):
        for name, a, op in mm_shapes[fuse]:
            m, k = a.shape
            ms = time_ms(lambda: int8_matmul_requant(a, op), reps=50)
            plain_ms = time_ms(lambda: int8_matmul_requant_plain(a, op), reps=3, warmup=1)
            b_ms, b_by = bound(*matmul_cost(m, k, op.n))
            lib_ms = None
            if m > 16 and k % 8 == 0 and op.n % 8 == 0:
                a8 = (a.to(torch.int16) - 128).to(torch.int8)
                w8 = op.wt[:, :k].contiguous().t()
                try:  # the yardstick only: the port never calls it
                    lib_ms = time_ms(lambda: torch._int_mm(a8, w8), reps=50)
                except RuntimeError as e:
                    log(f"[time] torch._int_mm refused {m}x{k}x{op.n}: {e}")
            entry = dict(shape=f"{name} {m}x{k}x{op.n}", fused_path=fuse, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            timing["int8_matmul_requant"].append(entry)
            log(f"[time] int8_matmul_requant {'fused' if fuse else 'unfused'} {entry['shape']}: "
                f"{ms:.4f} ms (bound {b_ms:.4f} {b_by}, plain {plain_ms:.3f}, "
                f"_int_mm {'n/a' if lib_ms is None else f'{lib_ms:.4f}'})")
    report["timing"] = timing

    throughput = {}
    for b in (8, 128):
        xb = torch.as_tensor(np.random.RandomState(1).randn(b, IMAGE, IMAGE, 3)
                             .astype(np.float32), device=dev)
        if not torch.equal(preds[True](xb), preds[False](xb)):
            raise AssertionError(f"batch {b}: fused logits != unfused logits")
        for fuse in (True, False):
            ms = time_ms(lambda: preds[fuse](xb), reps=10 if fuse else 3, warmup=1)
            throughput[f"bs{b}_{'fused' if fuse else 'unfused'}"] = {
                "ms_per_batch": ms, "images_per_sec": b / ms * 1e3}
            log(f"[time] serving batch {b} {'fused' if fuse else 'unfused'}: "
                f"{ms:.3f} ms/batch, {b / ms * 1e3:.1f} images/s")
    report["throughput"] = throughput

    def summary(name, source, replaces, fused_only):
        rows = [r for r in timing[name] if not fused_only or r.get("fused_path", True)]
        lib = [r["library_ms"] for r in rows]
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[True][name], "max_abs_err": max_err[name],
                "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": "bytes" if by_bytes * 2 >= sum(r["bound_ms"] for r in rows)
                else "operations",
                "library_ms": None if None in lib else sum(lib)}

    kernels = {"kernels": [
        summary("frost_block_int8", BLOCK_SOURCE, BLOCK_REPLACES, False),
        summary("int8_matmul_requant", MATMUL_SOURCE, MATMUL_REPLACES, True)]}
    report["kernels"] = kernels["kernels"]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
