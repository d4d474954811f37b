"""GPU smoke run of the PyTorch port: build, check and time its kernels, serve, train.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure, and any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving and training paths from
     ``frostnet_tpu_torch/csrc`` (one nvcc per source, started together),
     report what ``-Xptxas -v`` says of each fake-quant kernel (registers,
     shared memory, spills), and read the Frost block's, the dense conv's and
     the matmul's SASS (``cuobjdump -sass``): each must issue int8
     tensor-core instructions (IMMA from mma.sync, or GMMA from wgmma) and no
     dp4a (IDP);
  3. hold each kernel against its plain torch version on the card, bit-exact:
     the 18 Frost-block shapes of frostnet_quant_large_1_0 at 224x224, at
     batch 1, 8 and 128 (each its own launch plan: cluster size, tile,
     chunk), for qnnpack and fbgemm, every INT8 matmul of the fused and unfused
     forwards (on the inputs those forwards give it, and with an fbgemm grid),
     and the matmul at shapes that cut its tiles (``MATMUL_EDGES``: M=8 and
     392, K=27 and 147, K=1152 with N=256, N=1000 and 300), u8 and s8, qnnpack and
     fbgemm, and with rows that are not 16-byte aligned;
  4. the main path: serve the committed artifact through ``Int8Predictor``
     fused and unfused; the codes of every layer (QuantStub, stem, the 18
     blocks, last_layer, pool) must match the committed digests of the JAX
     ``freeze()`` codes, the logits must equal the committed JAX logits bit
     for bit, and the launch counts must be 18 blocks + 3 matmuls (fused)
     and 52 matmuls (unfused) per forward;
  5. ``serve.main`` for 20 iterations;
  6. timings with CUDA events: each kernel at its main-path shapes beside its
     bound (with the achieved TOP/s and TB/s and the share of the bound), its
     plain version and ``torch._int_mm`` (GEMM only, where its shape rules
     allow), and images/s at batch 8 and 128, fused and unfused (whose logits
     must agree at both batches). Every kernel's ``ms`` is the wall time of
     back-to-back calls; the block, matmul and conv rows also give
     ``device_ms`` (a CUDA graph of many launches, replayed: the wrappers'
     host work, which bounds the wall time at small shapes, stays out), their
     rates and bound share come from it, and ``torch._int_mm`` is timed both
     ways; the blocks' wall and device time summed at batch 1 and 128
     too (``time_blocks`` of ``scripts/time_frost_block.py``); one
     profiled fused forward at batch 8 split into the block kernel, the
     matmul kernel and the torch ops, with the device's idle share;
  7. the fake-quant kernel against its plain version, bit for bit, at every
     per-tensor site of a full-width QAT forward (224x224, batch 8,
     qnnpack; the inputs of a forward with fresh observers and of one with
     calibrated ones), each in float32 and bfloat16: y, the STE mask, the
     new observer state and the qparams; then the QAT_FROZEN pass on the
     new state, and the STE gradient of the largest site; then the smallest
     site (the kernel's cluster shape) and the largest (its grid shape),
     each captured in a CUDA graph and replayed twice, against the plain
     version applied twice;
  8. the training main path against the committed JAX reference
     (``testdata/*_train_reference.npz``): from ``numpy_init(seed 0)`` in
     float32 with TF32 off, one FP32 step, ``start_qat``, two QAT steps and a
     QAT_FROZEN eval step (QSGD lr 0.04, ``grouped_weight_decay(4e-5)``, the
     GradBoost noise off); losses, top-1, every observer and every BN's
     running statistics within the bands below; the fake-quant launches
     per FP32 step (0), per QAT step and per eval forward (one per site);
  9. the trained model frozen and served fused: 18 + 3 launches, finite
     logits equal to the unfused ones;
 10. the training step as ``bench.py`` runs it (bf16, QSGD lr 0.04,
     ``grouped_weight_decay(4e-5)``) at batch 128 and 256 (where it fits):
     ms/step and images/s of the QAT and FP32 steps, peak memory, and the
     fake-quant kernel at that step's sites (``time_sites`` of
     ``scripts/time_fake_quant.py``: device, graph, wall and host time, in
     all and by bucket of site size) beside its bound, its plain version and
     ``torch.fused_moving_avg_obs_fake_quant``;
 11. the dense 3x3 INT8 conv kernel against its plain version, bit for bit:
     at the 20 dense 3x3 stride-1 convs of the GAN generator
     (``resnet_9blocks``, ngf 64, 256x256, batch 4) on the inputs the
     committed artifact's forward gives them, at the same shapes on an
     fbgemm grid (per-channel scales, qmax 127) with and without ReLU, and
     on ragged shapes for its edge tiles (13x21, 68 -> 36 channels, and
     37x75, 68 -> 132: W past its 64 columns, Cout past its 128 channels,
     Cin not a multiple of its 32-channel chunk); and the matmul kernel at
     the generator's 3 im2col convs (the stem, K=147, and the strided downs,
     K=576 and 1152) the same two ways;
 12. the GAN main path, with cuDNN's TF32 at its default (phases 1-10 run
     with it off): ``GanPredictor`` serves the committed artifact
     (``testdata/resnet_9blocks_int8.npz``) at batch 4; the codes of every
     layer must match the committed digests of the JAX ``freeze()`` codes,
     the output must lie within ``GAN_TAIL_BAND`` of the committed JAX
     output while the tail run in TF32 must not, and one forward must
     launch the conv kernel 20 times and the matmul kernel 3 times; then
     ``serve.main --workload gan``;
 13. timings: the conv kernel at each of its 20 shapes at batch 8 beside its
     bound (achieved TOP/s, share of the bound), its plain version and
     ``torch._int_mm`` on the im2col operand (GEMM only), and the matmul
     kernel at the 3 im2col convs the same way (achieved TB/s and TOP/s);
     GAN serving ms/batch and images/s at batch 1, 8 and 16; and one
     profiled forward at batch 8 split into the conv kernel, the matmul
     kernel and the torch ops between them.
 14. the classification trainer and evaluator, the CLI path users run
     (``frostnet_tpu_torch.train.classification`` and ``.evaluate``), at
     full width with TF32 off (float32, as the JAX trainer computes):
     ``classification.main`` (``frostnet_quant_large_1_0``, 224x224, 1000
     classes, synthetic data, batch 64, 4 steps an epoch, one FP32 epoch and
     two QAT epochs, QSGD under ``cos_lr``, EMA 0.9999): every logged loss
     finite, 0 fake-quant launches per FP32 step and 166 per QAT step, 52
     matmul launches per INT8 evaluation forward, ``checkpoint/``, ``best/``,
     ``checkpoint_meta.json`` and ``metrics.jsonl`` written; a resume to a
     third QAT epoch (it must start at QAT epoch 2 and step 12, apply
     ``cos_lr`` over 16 steps at count 12, and restore the saved noise
     generator); ``evaluate.main`` on ``best/`` (2 calibration batches, the
     EMA swapped in, ``--export_int8``); ``serve.main`` on that artifact,
     unfused and fused, whose logits must equal bit for bit the in-process
     ``freeze`` of the evaluator's restored and recalibrated model. It
     prints images/s of each epoch, each step's wall time and peak memory.
 15. the MobileNets at full width (224x224, 1000 classes, qnnpack), with
     TF32 off: (1) ``qmobilenet_v2_ReLU`` and ``qmobilenet_v3_large_HS``
     built from ``numpy_init(seed 0)`` and the committed calibration
     (``testdata/<model>_calibration.npz``), written by the port's
     ``export_int8`` and served by ``Int8Predictor`` at batch 8: every
     layer's codes against the committed JAX digests (MobileNetV3 within
     ``MB_FLIP_SHARE``), the logits against JAX's (MobileNetV2 within one
     step of the classifier's grid), one matmul launch per 1x1 or im2col
     conv and nothing else, the matmul kernel against its plain version at
     every INT8 matmul of both forwards (aligned and unaligned rows); (2)
     the fake-quant kernel against its plain version at every per-tensor
     site of two ``qmobilenet_v3_large_HS`` QAT forwards at batch 8, float32
     and bfloat16, with the QAT_FROZEN pass; (3) both models' bf16 QAT and
     FP32 steps at batch 128 and 256: ms/step, images/s, peak memory, and
     fake-quant launches per QAT step (one per site) and per FP32 step (0);
     (4) ``classification.main`` on ``qmobilenet_v3_large_HS`` (batch 64, 2
     steps an epoch, one FP32 and one QAT epoch), ``evaluate.main
     --export_int8`` on ``best/`` and ``serve.main`` on that artifact,
     whose logits must equal the in-process ``freeze`` bit for bit; (5)
     serving images/s at batch 8 and 128, one profiled forward at batch 8
     (the matmul kernel, the torch ops, the idle share) and the device time
     of the torch-op groups (depthwise convs, hard-swishes,
     squeeze-excites: a CUDA graph of each group's calls on that forward's
     inputs, replayed).
 16. the ResNets at full width (224x224, 1000 classes, qnnpack), with TF32
     off: (1) ``qresnet18`` and ``qresnet50`` built from ``numpy_init(seed
     0)`` and the committed calibration (``testdata/<model>_calibration.npz``),
     written by the port's ``export_int8`` and served by ``Int8Predictor`` at
     batch 8: every layer's codes against the committed JAX digests, the
     logits within one step of the ``fc`` output grid (equal on the CPU),
     launches 13 dense convs + 7 / 40 matmuls a forward and nothing else;
     the dense conv kernel against its plain version at every dense conv of
     both forwards (the forward's inputs, and an fbgemm grid with and
     without ReLU) and the matmul kernel at every matmul (aligned and
     unaligned rows); (2) the grouped INT8 route (torch ops) at ResNeXt-101
     32x8d's four stage shapes at batch 2, card against CPU; (3) the
     fake-quant kernel at every per-tensor site of a qresnet50 QAT forward at
     batch 8 (125), float32 and bfloat16, with the QAT_FROZEN pass, and its
     largest site at batch 256 in bfloat16 (205.5 M elements); (4) both
     models' bf16 QAT and FP32 steps at batch 128 and 256 (51 / 125
     fake-quant launches a QAT step, 0 an FP32 step); (5)
     ``classification.main`` on ``qresnet18`` (batch 64, 2 steps an epoch,
     one FP32 and one QAT epoch), ``evaluate.main --export_int8`` and
     ``serve.main`` on its artifact, whose logits must equal the in-process
     ``freeze``; (6) the dense conv at its four ResNet shapes with ReLU at
     batch 8 and 128, and qresnet50's distinct matmul shapes at batch 8, each
     with wall and device time, bound, plain version and ``torch._int_mm``;
     serving images/s at batch 8 and 128; one profiled forward at batch 8.
 17. semantic segmentation at the Cityscapes crop of 768x768 (19 classes,
     the LR-ASPP pool (37, 12), qnnpack), with TF32 off: (a)
     ``mobilenetv3_RE_small`` (the trainer's default) and
     ``mobilenetv3_large`` built from ``numpy_init(seed 0)`` and the
     committed calibration (``testdata/seg_<model>_calibration.npz``),
     written by the port's ``export_int8``, read back with ``load_int8`` and
     frozen, on 2 images: every layer's codes (``quant``, each trunk block,
     the LR-ASPP head and its gate) against the committed JAX digests, the
     sampled logits within ``SEG_LOGIT_BAND`` of their range and the argmax
     within ``SEG_ARGMAX_SHARE`` (an image whose codes moved at a
     squeeze-excite: the flip bands ``SEG_FLIP_*``), one matmul launch per
     1x1 or im2col conv and nothing else; (b) the matmul kernel against its
     plain version at every INT8 matmul of both forwards at batch 8 and 16
     (the stem at M = 2,359,296, the gate at M = batch; aligned and
     unaligned rows); (c) the fake-quant kernel against its plain version at
     every site of a float32 QAT forward of the default model at batch 16,
     with the QAT_FROZEN pass; (d) one FP32 and two QAT steps and a
     QAT_FROZEN eval step at 256x256, batch 2, against the committed JAX
     reference (``testdata/seg_mobilenetv3_RE_small_train_reference.npz``) in
     phase 8's bands, with the fake-quant launches of each step; (e)
     ``segmentation.train.main`` (synthetic, batch 8, 2 steps an epoch, one
     FP32 and one QAT epoch), its resume to a second QAT epoch,
     ``segmentation.evaluate.main --export_int8`` on ``best/``, whose
     artifact served in a fresh model gives the evaluator's INT8 mIoU, and
     ``evaluate.main`` on the final ``checkpoint/``, which gives the
     trainer's; each step's launches; (f) the INT8 forward at batch 1, 8 and
     16, one profiled forward at batch 8 with the torch-op groups (dilated
     depthwise, hard-swish, squeeze-excite), the float32 QAT and FP32 train
     steps at batch 16 (ms, peak memory), the matmul kernel at each distinct
     matmul of the batch-16 forward and the fake-quant kernel at the sites
     of (c), beside their bounds, plain versions and library calls.
 18. object detection at 300x300 (VOC: 21 classes, 8,732 / 8,744 priors,
     qnnpack), with TF32 off: (a) SSDLite-MobileNetV2 (``qssd``) and
     Tiny-DSOD (``qtdsod``) built from ``numpy_init(seed 0)`` and the
     committed calibration (``testdata/det_<net>_calibration.npz``), written
     by the port's ``export_int8`` as ``_feat.npz`` and ``_head.npz`` and
     served by ``serve.DetPredictor`` on 2 images: every layer's codes and
     each dequantized source against the committed JAX digests, loc and conf
     within ``DET_HEAD_BAND`` of their range, ``detect``'s kept boxes at the
     server's settings (``DET_SERVE``) within ``DET_BOX_BAND``, one matmul
     launch per 1x1 or im2col conv (38 / 39) and nothing else; (b) the
     matmul kernel against its plain version at every INT8 matmul of both
     forwards at batch 8 and 32 (the stems at M = B x 22,500, K = 27;
     aligned and unaligned rows), and the fake-quant kernel at all 127 sites
     of a float32 qssd QAT forward at batch 32, with the QAT_FROZEN pass;
     (c) one FP32 and two QAT steps and a QAT_FROZEN eval of the loss at
     300x300, batch 2, against the committed JAX reference
     (``testdata/det_qssd_train_reference.npz``), the steps in phase 8's
     bands and the eval in ``DET_EVAL_LOSS_REL``, with the fake-quant launches
     of each step; (d) qssd's float32 FP32 and QAT steps at batch 32 (ms,
     images/s, peak memory, launches: 127 fake-quant a QAT step); (e)
     ``detection.train.main`` (synthetic, batch 32, 2 FP32 warm-up and 2 QAT
     iterations), its resume to a fifth, ``qeval.evaluator`` with
     ``--export_int8``, whose artifact served in a fresh ``DetPredictor``
     gives its INT8 mAP (and the calibrated fixture's, whose mAP is not 0),
     and ``serve.main --workload det``; each step's launches; (f) the INT8
     forward with and without ``detect`` at batch 1, 8 and 32, one profiled
     forward at batch 8, ``detect`` alone at the server's and the
     evaluator's settings (device time and launches), the matmul kernel at
     each distinct matmul of the batch-8 forwards and the fake-quant kernel
     at the sites of (b), beside their bounds, plain versions and library
     calls.
The ``kernels`` line sums each kernel over its main paths: the matmul
kernel over the fused FrostNet forward (batch 8) and the GAN forward
(batch 8 for times, one forward each for launches). Its ``ms`` and
``library_ms`` are wall times of back-to-back calls, except the fake-quant
kernel's, which are torch.profiler device time; the block, matmul and conv
entries add ``device_ms`` and ``library_device_ms``, the fake-quant entry
``device_ms`` (a replayed CUDA graph of the sites) and ``wall_ms``. A
matmul's bound counts its own K, not the zero columns the im2col route pads
rows with.
Each entry also gives ``trainer_launches``, its launches in phase 14,
``mobilenet_launches``, its launches on each path of phase 15 (the two
served forwards, each model's training, the trainer path),
``resnet_launches``, the same for phase 16, ``seg_launches``, its
launches on phase 17's paths (the two served forwards, the training check
against the reference, the trainer path), and ``det_launches``, the same for
phase 18 (the two served forwards, the training check, the timed steps, the
trainer path).
It prints a ``kernels`` JSON line, the card line, and last the device JSON.
Details go to ``build/chip_smoke.json`` (``--out`` puts them elsewhere).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from frostnet_tpu_torch import ops
from frostnet_tpu_torch.models import CascadePreExBottleneck, create_model
from frostnet_tpu_torch.nn import (FP32, INT8, QAT, QAT_FROZEN, Observer, QConvBNAct, QHswish,
                                   QSEModule, quant_ops)
from frostnet_tpu_torch.ops import cuda_build
from frostnet_tpu_torch.ops.fake_quant import (ObservedFakeQuant, fake_quant_observe,
                                               fake_quant_observe_plain, plan_fake_quant)
from frostnet_tpu_torch.ops.frost_block import (frost_block_int8, frost_block_int8_plain,
                                                plan_launch, random_block_case, sm_count)
from frostnet_tpu_torch.ops.int8_conv import (conv3x3_operands, conv3x3_s1_int8,
                                              conv3x3_s1_int8_plain)
from frostnet_tpu_torch.ops.int8_matmul import (conv1x1_operands, int8_matmul_requant,
                                                int8_matmul_requant_plain)
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import (ObserverState, QParams, QTensor, export_int8, freeze,
                                      from_jax_variables, get_qconfig, model_variables, numpy_init)
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
from frostnet_tpu_torch.serve import GanPredictor, Int8Predictor
from frostnet_tpu_torch import serve
from frostnet_tpu_torch.train import (create_train_state, make_eval_step, make_train_step,
                                      prep_image)
from scripts.time_fake_quant import bucket_lines, time_sites
from scripts.time_frost_block import time_blocks

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(ROOT, "frostnet_tpu_torch", "testdata")
MODEL = "frostnet_quant_large_1_0"
ARTIFACT = os.path.join(TESTDATA, f"{MODEL}_int8.npz")
REFERENCE = os.path.join(TESTDATA, f"{MODEL}_reference.npz")
TRAIN_REFERENCE = os.path.join(TESTDATA, f"{MODEL}_train_reference.npz")
IMAGE, BATCH, CLASSES = 224, 8, 1000
BLOCK_BATCHES = (1, 8, 128)  # phase 3a: each batch size has its own launch plan
# H100 SXM, dense: HBM rate, int8 tensor-core rate, float32 outside the
# tensor cores (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_F32_OPS_PER_S = 67e12
BLOCK_SOURCE = "frostnet_tpu_torch/csrc/frost_block.cu"
MATMUL_SOURCE = "frostnet_tpu_torch/csrc/int8_matmul.cu"
FQ_SOURCE = "frostnet_tpu_torch/csrc/fake_quant.cu"
BLOCK_REPLACES = "frostnet_tpu/ops/pallas_frost_block.py:354"
MATMUL_REPLACES = "frostnet_tpu/ops/pallas_int8_matmul.py:42"
FQ_REPLACES = "frostnet_tpu/ops/pallas_fake_quant.py:80"
CONV_SOURCE = "frostnet_tpu_torch/csrc/int8_conv.cu"
CONV_REPLACES = "frostnet_tpu/ops/pallas_int8_conv.py:145"
GAN = "resnet_9blocks"
GAN_ARTIFACT = os.path.join(TESTDATA, f"{GAN}_int8.npz")
GAN_REFERENCE = os.path.join(TESTDATA, f"{GAN}_reference.npz")
GAN_IMAGE, GAN_BATCH = 256, 4
GAN_LAUNCHES = {"int8_matmul_requant": 3, "frost_block_int8": 0, "fake_quant_observe": 0,
                "int8_conv": 20}
# The GAN's float32 tail after tanh against the committed JAX output,
# absolute: XLA's space-to-depth route and cuDNN sum the 7x7 conv in other
# orders. Measured 5.8e-6 on the CPU (tests/test_torch_gan_fixture.py, the
# same band) and 5.66e-6 on the H100; the tail run in TF32 misses it by
# ~1.7e-3, which phase 12 checks.
GAN_TAIL_BAND = 3e-5
N_SITES = 166  # per-tensor sites of one qnnpack QAT forward of the model
# (M, K, N) of matmuls that cut the kernel's tiles (64 or 128 rows; 64, 128
# or 256 columns; 128-byte K chunks; TMA only for 16-byte aligned rows)
MATMUL_EDGES = [(8, 27, 1000), (8, 1280, 1000), (392, 320, 1280), (392, 576, 128),
                (5000, 147, 64), (4096, 1152, 256), (1000, 40, 72), (17000, 576, 300)]
# Bands of the training check against the JAX reference (float32, TF32 off).
# The FP32 step starts from the same weights: only the order of the float
# sums differs (cuDNN against XLA on the CPU), relative ~1e-6.
FP32_LOSS_REL = 1e-4
# QAT: fed the same input, every layer agrees to ~1e-6 except where a value
# sits on a rounding boundary and its code moves by one quantum; when that
# value is a tensor's observed extreme, the whole tensor's grid moves and
# the next layers carry it. The port on the CPU against the same reference:
# QAT losses 0.9% and 0.6% apart, the eval loss 0.03%, observers 0.75% of
# their range in the median and 16% at worst, BN means 0.27% of a std and
# variances 2.7% in the median (tests/test_torch_train_step.py states the
# same at 32x32).
QAT_LOSS_REL = 0.05
OBS_MEDIAN, OBS_WORST = 0.03, 0.5      # of the observed range
BN_MEAN_MEDIAN, BN_VAR_MEDIAN = 0.05, 0.1  # |d mean| / std, |d var| / var


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


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn`` (ms per call): ``reps`` calls captured in one
    CUDA graph, one replay timed with CUDA events. The host's work (the
    wrappers' Python and ctypes, longer than a small kernel) stays out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 3) -> float:
    """Device time of ``fn`` (ms per call): the summed durations of the
    kernels it launches, from torch.profiler, without the host's gaps."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")
    return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3


def bound(nbytes: float, nops: float, peak_ops: float = PEAK_INT8_OPS_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, nops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rates(nbytes: float, nops: float, ms: float, bound_ms: float):
    """Achieved TOP/s and TB/s of one call, and the share of its bound."""
    return {"tops": nops / ms / 1e9, "tbps": nbytes / ms / 1e9, "bound_share": bound_ms / ms}


def rates_text(r) -> str:
    return (f"{r['tops']:.1f} TOP/s, {r['tbps']:.3f} TB/s, {100 * r['bound_share']:.1f}% of "
            f"the bound")


def check_sass():
    """Phase 2: the Frost block, the dense conv and the matmul issue int8
    tensor-core instructions (mma.sync: IMMA in SASS; wgmma: GMMA) and no
    dp4a (IDP)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found = {}
    for name in ("frost_block", "int8_conv", "int8_matmul"):
        sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(name))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        ops = {}
        for line in sass.splitlines():
            for word in line.replace(";", " ").split():
                if "GMMA" in word or "IMMA" in word or word.startswith("IDP"):
                    ops[word] = ops.get(word, 0) + 1
        mma = sum(n for w, n in ops.items() if "GMMA" in w or "IMMA" in w)
        dp4a = sum(n for w, n in ops.items() if w.startswith("IDP"))
        if mma == 0 or dp4a:
            raise AssertionError(f"{name}: {mma} tensor-core (IMMA, GMMA) and {dp4a} dp4a (IDP) "
                                 f"instructions in its SASS; expected tensor-core only: {ops}")
        found[name] = ops
    return found


def ptxas_kernels(name):
    """``-Xptxas -v`` of the fake-quant source ``name``, one entry a kernel
    (its name, element type and launch shape): registers, static shared
    memory and spill bytes."""
    rows, row = [], None
    for line in cuda_build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base, _, args = mangled[mangled.find("fq_"):].partition("I")
            kind = "bfloat16" if "bfloat16" in args else "float32"
            kind += ", cluster" if "Lb1E" in args else ", grid" if "Lb0E" in args else ""
            row = {"kernel": f"{base}<{kind}>", "spill_stores": 0, "spill_loads": 0, "smem": 0}
            rows.append(row)
        elif row is not None and "spill stores" in line:
            words = line.replace(",", " ").split()
            row["spill_stores"], row["spill_loads"] = int(words[4]), int(words[8])
        elif row is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            row["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                row["smem"] = int(words[words.index("smem") - 2])
    return rows


def edge_case_matmul(m, k, n, signed, qmax, dev, seed):
    """Seeded (x, operands) of one matmul: per-tensor scale on qnnpack,
    per-channel on fbgemm, each output spread over many codes."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randint(-128, 128, (m, k), generator=g).to(torch.int8) if signed else
         torch.randint(0, qmax + 1, (m, k), generator=g).to(torch.uint8))
    comb = (torch.rand(n if qmax == 127 else (), generator=g) * 2e-4 + 1e-4) / k ** 0.5
    op = conv1x1_operands(torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8), comb,
                          torch.randn(n, generator=g), 113, 0.02, 7, not signed, 0, qmax, dev)
    return x.to(dev), op


def check_matmul_edges(dev):
    """Phase 3c: the matmul kernel at ``MATMUL_EDGES``, u8 and s8, qnnpack
    and fbgemm, and the same inputs one byte into their storage (no row
    16-byte aligned)."""
    err, checked = 0, 0
    for i, (m, k, n) in enumerate(MATMUL_EDGES):
        for signed in (False, True):
            for qmax in (255, 127):
                x, op = edge_case_matmul(m, k, n, signed, qmax, dev, seed=1000 + i)
                want = int8_matmul_requant_plain(x, op)
                what = f"int8_matmul_requant edge {m}x{k}x{n} {'s8' if signed else 'u8'} qmax {qmax}"
                err = max(err, check_equal(what, int8_matmul_requant(x, op), want))
                if len(torch.unique(want)) <= 16:
                    raise AssertionError(f"{what}: only {len(torch.unique(want))} distinct codes")
                buf = torch.empty(m * k + 1, dtype=x.dtype, device=dev)
                xs = buf[1:].view(m, k)
                xs.copy_(x)
                err = max(err, check_equal(what + " (unaligned rows)", int8_matmul_requant(xs, op),
                                           want))
                checked += 2
    torch.cuda.synchronize()
    return err, checked


def fq_cost(x: torch.Tensor):
    """(bytes, float32 operations) of one site: x read once, y and the mask
    written once; ~10 operations an element (min, max, multiply, round,
    add, two compares, clamp, subtract, multiply)."""
    n = x.numel()
    return n * (2 * x.element_size() + 1) + 16, 10.0 * n


def matmul_cost(m, k, n):
    """(bytes, operations) of one matmul of the function's own K: x read
    once, the weight once, zterm/scale/bias vectors, uint8 out written once.
    Zero columns a caller pads x's rows with are not counted."""
    return m * k + k * n + 12 * n + m * n, 2.0 * m * n * k


def matmul_shape(a, op) -> str:
    """``MxKxN`` of a matmul, and the row length of x where it is padded."""
    m, k = a.shape
    return f"{m}x{op.k}x{op.n}" + ("" if k == op.k else f" (x rows padded to {k})")


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
        model(images, mode=INT8)
    for h in hooks:
        h.remove()
    return calls


def layer_codes(pred, images):
    """(output, {layer: codes}) of one ``pred(images)`` call: the codes each
    top-level module of the model outputs and, as ``pool``, the input of the
    classifier (``classifier``, or a ResNet's ``fc``). The hooks only keep
    references, so the call's launches are unchanged."""
    codes, hooks = {}, []

    def keep(name):
        def hook(mod, args, out):
            if name in ("classifier", "fc"):
                codes["pool"] = args[0].q
            elif isinstance(out, QTensor):
                codes[name] = out.q
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


def mobilenet_variables(name: str) -> dict:
    """The flat variables of a MobileNet fixture: ``numpy_init(model, 0)``
    with the committed calibration (BN shifts and statistics, observers)
    on top (``tests/test_torch_mobilenet_fixture.py`` makes it)."""
    flat = flatten_variables(numpy_init(create_model(name), 0))
    with np.load(os.path.join(TESTDATA, f"{name}_calibration.npz")) as cal:
        for k in cal.files:
            if k not in flat or flat[k].shape != cal[k].shape:
                raise AssertionError(f"{name} calibration: {k} does not fit the model")
            flat[k] = cal[k]
    return flat


def mobilenet_predictor(name: str, device, artifact_dir=None) -> Int8Predictor:
    """``Int8Predictor`` over the MobileNet fixture: the port's model filled
    with :func:`mobilenet_variables`, written by the port's ``export_int8``
    (into ``artifact_dir``, or a temporary directory) and served from it."""
    model = from_jax_variables(create_model(name), unflatten_variables(mobilenet_variables(name)))
    if artifact_dir:
        os.makedirs(artifact_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(artifact_dir or tmp, f"{name}_int8.npz")
        export_int8(model, artifact)
        return Int8Predictor(name, artifact=artifact, image_size=IMAGE, device=device)


def check_equal(what, got, want):
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel != plain version "
                             f"({int((got != want).sum())} codes differ, max abs err {err})")
    return err


def train_batch(k: int, batch: int = BATCH):
    """Batch ``k`` of the committed training reference: uint8 NHWC images,
    then labels, from ``RandomState(100 + k)``."""
    rng = np.random.RandomState(100 + k)
    return {"image": rng.randint(0, 256, (batch, IMAGE, IMAGE, 3)).astype(np.uint8),
            "label": rng.randint(0, CLASSES, batch).astype(np.int64)}


def capture_sites(model, images, mode):
    """``[(x, min_val, max_val, spec)]`` at every per-tensor site of one
    train-mode forward in ``mode``, in call order (the states as each site
    found them). The forward itself runs as usual."""
    sites, real = [], quant_ops.ObservedFakeQuant

    class Recorder:
        @staticmethod
        def apply(x, obs, spec, observe):
            sites.append((x.detach().clone(), obs.min_val.detach().clone(),
                          obs.max_val.detach().clone(), spec))
            return real.apply(x, obs, spec, observe)

    quant_ops.ObservedFakeQuant = Recorder
    try:
        with torch.no_grad():
            model(images, mode=mode, train=True)
    finally:
        quant_ops.ObservedFakeQuant = real
    return sites


def check_site(what, x, mn, mx, spec):
    """The kernel against its plain version at one site: the QAT passes (y,
    mask, new state, qparams), then the QAT_FROZEN pass on the new state."""
    kmin, kmax = mn.clone(), mx.clone()
    y, mask, qp = fake_quant_observe(x, kmin, kmax, spec, observe=True)
    py, pmask, pst, ps, pz = fake_quant_observe_plain(x, ObserverState(mn, mx), spec, True)
    got = (y, mask, kmin, kmax, qp[0], qp[1])
    want = (py, pmask, pst.min_val, pst.max_val, ps, pz.to(torch.float32))
    for name, g, w in zip(("y", "mask", "min_val", "max_val", "scale", "zero_point"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"fake_quant_observe {what}: {name} != plain version "
                                 f"({int((g != w).sum())} differ)")
    y2, m2, _ = fake_quant_observe(x, kmin, kmax, spec, observe=False)
    py2, pm2, _, _, _ = fake_quant_observe_plain(x, pst, spec, observe=False)
    if not (torch.equal(y2, py2) and torch.equal(m2, pm2)):
        raise AssertionError(f"fake_quant_observe {what}: the QAT_FROZEN pass != plain version")
    return float((y.float() - py.float()).abs().max())


def check_fake_quant(dev):
    """Phase 7: every per-tensor site of two full-width QAT forwards."""
    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    from_jax_variables(model, numpy_init(model, 0)).to(dev)
    checked, err = 0, 0.0
    for k in range(2):  # fresh observers (the snap), then calibrated (the EMA)
        sites = capture_sites(model, prep_image(torch.as_tensor(train_batch(k)["image"],
                                                                device=dev)), QAT)
        if len(sites) != N_SITES:
            raise AssertionError(f"{len(sites)} per-tensor sites in a QAT forward, "
                                 f"expected {N_SITES}")
        for i, (x, mn, mx, spec) in enumerate(sites):
            for dt in (torch.float32, torch.bfloat16):
                err = max(err, check_site(f"forward {k} site {i} {tuple(x.shape)} {dt}",
                                          x.to(dt), mn, mx, spec))
                checked += 1
    # the STE gradient of the largest site, through the autograd op
    x, mn, mx, spec = max(sites, key=lambda s: s[0].numel())
    obs = Observer().to(dev)
    obs.min_val.copy_(mn)
    obs.max_val.copy_(mx)
    xg = x.clone().requires_grad_(True)
    g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    ObservedFakeQuant.apply(xg, obs, spec, True).backward(g)
    _, pmask, _, _, _ = fake_quant_observe_plain(x, ObserverState(mn, mx), spec, True)
    if not torch.equal(xg.grad, torch.where(pmask, g, torch.zeros((), device=dev))):
        raise AssertionError("fake_quant_observe: STE gradient != where(plain mask, g, 0)")
    # the smallest and the largest site (both launch shapes) in a CUDA graph
    replayed = {}
    for x, mn, mx, spec in (min(sites, key=lambda s: s[0].numel()), (x, mn, mx, spec)):
        replayed[f"{tuple(x.shape)} {x.dtype}"] = check_graph_replay(x, mn, mx, spec)
    torch.cuda.synchronize()
    return checked, err, tuple(x.shape), replayed


def check_graph_replay(x, mn, mx, spec):
    """One observing site captured in a CUDA graph, replayed twice, against
    the plain version applied twice (y, mask, state, qparams): the grid
    shape's slots and generation and the state's in-place step are right on
    every replay. Returns the site's launch shape."""
    fake_quant_observe(x, mn.clone(), mx.clone(), spec)  # build, plan, scratch
    kmin, kmax = mn.clone(), mx.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, mask, qp = fake_quant_observe(x, kmin, kmax, spec)
    st = ObserverState(mn, mx)
    for k in range(2):
        graph.replay()
        torch.cuda.synchronize()
        py, pmask, st, ps, pz = fake_quant_observe_plain(x, st, spec)
        got = (y, mask, kmin, kmax, qp[0], qp[1])
        want = (py, pmask, st.min_val, st.max_val, ps, pz.to(torch.float32))
        names = ("y", "mask", "min_val", "max_val", "scale", "zero_point")
        for name, g, w in zip(names, got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"fake_quant_observe {tuple(x.shape)} {x.dtype}, graph replay "
                                     f"{k + 1}: {name} != plain version")
    del graph
    plan = plan_fake_quant(x.numel(), x.element_size(), x.data_ptr() % 16 == 0,
                           sm_count(x.device.index or 0))
    return f"{'cluster' if plan.cluster else 'grid'} of {plan.blocks}"


def band_check(what, value, limit):
    log(f"[train] {what}: measured {value:.6g} (band {limit:g})")
    if not value <= limit:
        raise AssertionError(f"{what}: {value} outside the band {limit}")


def train_against_reference(dev):
    """Phase 8: the training main path against the committed JAX reference.
    Returns (state, launch counts of the run, report)."""
    ref = np.load(TRAIN_REFERENCE)
    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    fq = ops.fake_quant_observe
    ops.reset_launch_counts()
    state = create_train_state(model, tx, seed=0, device=dev)
    steps = [make_train_step(FP32, num_classes=CLASSES), make_train_step(QAT, num_classes=CLASSES),
             make_train_step(QAT, num_classes=CLASSES), make_eval_step(QAT_FROZEN, CLASSES)]
    metrics, launches = [], []
    for k, step in enumerate(steps):
        if k == 1:
            state.start_qat()
        before = fq.launches
        metrics.append({n: float(v) for n, v in step(state, train_batch(k)).items()})
        launches.append(fq.launches - before)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    names = ["FP32 step", "QAT step 1", "QAT step 2", "QAT_FROZEN eval"]
    for name, m, want_loss, want_top1 in zip(names, metrics, ref["loss"], ref["top1"]):
        log(f"[train] {name}: loss {m['loss']:.6f} (JAX {want_loss:.6f}), top1 {m['top1']} "
            f"(JAX {want_top1})")
    expect = [0, N_SITES, N_SITES, N_SITES]
    if launches != expect:
        raise AssertionError(f"fake_quant_observe launches per phase {launches} != {expect}")
    log(f"[train] fake_quant_observe launches: FP32 step {launches[0]}, QAT steps {launches[1]} "
        f"and {launches[2]} ({N_SITES} sites, one launch each), QAT_FROZEN forward "
        f"{launches[3]}")
    rep = {"metrics": metrics, "launches_per_phase": dict(zip(names, launches))}
    rel = [abs(m["loss"] - float(w)) / float(w) for m, w in zip(metrics, ref["loss"])]
    rep["loss_rel"] = rel
    band_check("FP32 step loss, relative to JAX", rel[0], FP32_LOSS_REL)
    band_check("QAT and eval losses, worst relative to JAX", max(rel[1:]), QAT_LOSS_REL)
    top1 = max(abs(m["top1"] - float(w)) for m, w in zip(metrics, ref["top1"]))
    band_check("top-1, worst difference", top1, 1.0 / BATCH)
    mine = {k: v.detach().cpu().numpy() for k, v in model_variables(state.model).items()}
    obs = []
    for k in ref.files:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(ref[hi] - ref[k]), 1e-6)
            obs.append(max(abs(float(mine[k] - ref[k])), abs(float(mine[hi] - ref[hi]))) / span)
    if len(obs) != N_SITES or not all(np.isfinite(mine[k]).all() for k in mine):
        raise AssertionError("observers missing or not finite after training")
    rep["observer_rel_range"] = {"median": float(np.median(obs)), "worst": float(max(obs))}
    band_check("observers, median |diff| / range", float(np.median(obs)), OBS_MEDIAN)
    band_check("observers, worst |diff| / range", float(max(obs)), OBS_WORST)
    bn_mean, bn_var = [], []
    for k in ref.files:
        if k.endswith("/mean"):
            v = k[:-len("mean")] + "var"
            bn_mean.append(float(np.max(np.abs(mine[k] - ref[k]) / np.sqrt(ref[v]))))
            bn_var.append(float(np.max(np.abs(mine[v] - ref[v]) / ref[v])))
    rep["bn"] = {"mean_over_std_median": float(np.median(bn_mean)), "mean_over_std_worst":
                 float(max(bn_mean)), "var_rel_median": float(np.median(bn_var)),
                 "var_rel_worst": float(max(bn_var))}
    band_check("BN running means, median |diff| / std", float(np.median(bn_mean)), BN_MEAN_MEDIAN)
    band_check("BN running variances, median |diff| / var", float(np.median(bn_var)),
               BN_VAR_MEDIAN)
    log(f"[train] worst BN: mean {max(bn_mean):.4g} of a std, var {max(bn_var):.4g} relative")
    return state, counts, rep


def serve_trained(state, dev):
    """Phase 9: freeze the trained model and serve one batch, fused and unfused."""
    images = np.random.RandomState(0).randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    logits, counts = {}, {}
    for fuse in (True, False):
        port = create_model(MODEL, num_classes=CLASSES, fuse_int8=fuse)
        port.load_state_dict(state.model.state_dict())
        fn = freeze(port, dev, IMAGE)
        ops.reset_launch_counts()
        logits[fuse] = fn(images)
        torch.cuda.synchronize()
        counts[fuse] = ops.launch_counts()
    want = {"frost_block_int8": 18, "int8_matmul_requant": 3, "fake_quant_observe": 0,
            "int8_conv": 0}
    if counts[True] != want:
        raise AssertionError(f"trained model, fused: launches {counts[True]} != {want}")
    lg = logits[True]
    if lg.shape != (BATCH, CLASSES) or not torch.isfinite(lg).all():
        raise AssertionError(f"trained model: bad logits {tuple(lg.shape)}")
    if not torch.equal(lg, logits[False]):
        raise AssertionError("trained model: fused logits != unfused logits")
    log(f"[train] trained model frozen and served fused: launches {counts[True]}, logits "
        f"finite, == unfused, {len(torch.unique(lg))} distinct values")
    return counts[True]


def time_fake_quant_sites(sites):
    """The fake-quant kernel over the sites of one QAT forward
    (``time_sites`` of ``scripts/time_fake_quant.py``: profiler device time,
    CUDA-graph time, wall and host time, in all and by bucket, with the
    bound), the plain version's time, and the library yardstick
    ``torch.fused_moving_avg_obs_fake_quant`` (float32 only: it runs on
    float32 copies), profiler device time and wall time."""
    out = time_sites(sites, time_ms, graph_ms, fq_cost,
                     lambda b, o: bound(b, o, PEAK_F32_OPS_PER_S))
    del out["per_site"]

    def plain_all():
        for x, mn, mx, spec in sites:
            fake_quant_observe_plain(x, ObserverState(mn, mx), spec)

    out["plain_ms"] = time_ms(plain_all, reps=1, warmup=1)
    dev = sites[0][0].device
    on = torch.ones(1, dtype=torch.long, device=dev)
    lib_args = [(x.to(torch.float32), mn.reshape(1).clone(), mx.reshape(1).clone(),
                 torch.ones(1, device=dev), torch.zeros(1, dtype=torch.int32, device=dev), spec)
                for x, mn, mx, spec in sites]

    def library_all():  # the yardstick only: the port never calls it
        for xf, rmin, rmax, scale, zp, spec in lib_args:
            torch.fused_moving_avg_obs_fake_quant(xf, on, on, rmin, rmax, scale, zp, 0.01,
                                                  spec.qmin, spec.qmax, 0, False, spec.symmetric)

    try:
        out["library_ms"] = device_ms(library_all)
        out["library_wall_ms"] = time_ms(library_all, reps=5)
    except RuntimeError as e:
        log(f"[time] torch.fused_moving_avg_obs_fake_quant refused: {e}")
        out["library_ms"] = out["library_wall_ms"] = None
    del lib_args
    return out


def time_training(dev, name=MODEL, time_sites=True, reps=(5, 10)):
    """Phase 10 (and 15): the benchmarked training step of ``name`` (bf16,
    bench.py's optimizer); with ``time_sites`` also the fake-quant kernel
    at the QAT forward's sites at batch 128. Each record has the
    fake-quant launches of one FP32 and one QAT step."""
    out = {}
    kernel = ops.fake_quant_observe
    for b in (128, 256):
        rec = {}
        try:
            model = create_model(name, num_classes=CLASSES, dtype=torch.bfloat16)
            tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5))
            state = create_train_state(model, tx, seed=0, device=dev)
            batch = {k: torch.as_tensor(v, device=dev) for k, v in train_batch(0, b).items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fp32_step = make_train_step(FP32, num_classes=CLASSES)
            before = kernel.launches
            fp32_step(state, batch)
            rec["fp32_fake_quant_launches"] = kernel.launches - before
            rec["fp32_ms_per_step"] = time_ms(lambda: fp32_step(state, batch), reps=reps[0])
            state.start_qat()
            qat_step = make_train_step(QAT, num_classes=CLASSES)
            before = kernel.launches
            qat_step(state, batch)
            rec["qat_fake_quant_launches"] = kernel.launches - before
            rec["qat_ms_per_step"] = time_ms(lambda: qat_step(state, batch), reps=reps[1])
            rec["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        except torch.cuda.OutOfMemoryError as e:
            if b == 128:
                raise
            log(f"[time] training batch {b} does not fit: {str(e).splitlines()[0]}")
            out[f"bs{b}"] = {"fits": False}
            break
        rec["fp32_images_per_sec"] = b / rec["fp32_ms_per_step"] * 1e3
        rec["qat_images_per_sec"] = b / rec["qat_ms_per_step"] * 1e3
        log(f"[time] {name} training batch {b} (bf16): QAT {rec['qat_ms_per_step']:.3f} ms/step "
            f"{rec['qat_images_per_sec']:.1f} images/s; FP32 {rec['fp32_ms_per_step']:.3f} "
            f"ms/step {rec['fp32_images_per_sec']:.1f} images/s; peak memory "
            f"{rec['max_memory_allocated_gib']:.2f} GiB; fake_quant_observe launches per QAT "
            f"step {rec['qat_fake_quant_launches']}, per FP32 step "
            f"{rec['fp32_fake_quant_launches']}")
        if b == 128 and time_sites:
            sites = capture_sites(state.model, prep_image(batch["image"]), QAT)
            fq = rec["fake_quant"] = time_fake_quant_sites(sites)
            lib = "n/a" if fq["library_ms"] is None else (
                f"{fq['library_ms']:.4f} device, {fq['library_wall_ms']:.4f} wall")
            log(f"[time] fake_quant_observe, the {len(sites)} sites of a QAT forward at batch "
                f"{b}: {fq['ms']:.4f} ms device, {fq['graph_ms']:.4f} graph, {fq['wall_ms']:.4f} "
                f"wall, {fq['host_ms']:.4f} host ({fq['launches_per_site']} launch a site; bound "
                f"{fq['bound_ms']:.4f} {fq['bound_by']}, {100 * fq['bound_share']:.1f}%; plain "
                f"{fq['plain_ms']:.3f}, fused_moving_avg_obs_fake_quant {lib})")
            for line in bucket_lines(fq):
                log(f"    {line}")
            del sites
        out[f"bs{b}"] = rec
        del state, model, batch
        torch.cuda.empty_cache()
    return out


def gan_images(seed: int, batch: int, size: int = GAN_IMAGE) -> np.ndarray:
    """Seeded images in [-1, 1] (those of the committed GAN reference)."""
    return np.random.RandomState(seed).uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)


def capture_convs(pred, images, route):
    """``[(name, conv, input codes)]`` of the convs on INT8 route ``route``
    (``dense3x3`` or ``im2col``) of one forward."""
    calls, hooks = [], []
    for name, mod in pred.model.named_modules():
        if isinstance(mod, QConvBNAct) and getattr(mod, "_route", None) == route:
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, name=name: calls.append((name, m, args[0].q))))
    try:
        pred(images)
    finally:
        for h in hooks:
            h.remove()
    return calls


def conv3x3_cost(x_shape, cout):
    """(bytes, operations) of one conv: codes read once, weights and the
    epilogue vectors once, uint8 codes written once."""
    b, h, w, cin = x_shape
    return b * h * w * (cin + cout) + 9 * cin * cout + 12 * cout, 2.0 * b * h * w * 9 * cin * cout


def matmul_operand(mod, x):
    """The (M, K) uint8 operand a conv's matmul or im2col route gives the
    matmul kernel for input codes ``x``."""
    a = mod.matmul_input(x)
    return a.reshape(-1, a.shape[-1]).contiguous()


def int_mm_ms(a, wt, reps):
    """``torch._int_mm`` on the int8 operand (codes - 128) and the packed
    (N, K) weight: the GEMM-only yardstick, as (CUDA-event wall ms, device
    ms); (None, None) where its shape rules refuse (M <= 16, K or N not a
    multiple of 8)."""
    m, k = a.shape
    if m <= 16 or k % 8 or wt.shape[0] % 8:
        return None, None
    a8 = (a.to(torch.int16) - 128).to(torch.int8)
    w8 = wt[:, :k].contiguous().t()
    try:  # the yardstick only: the port never calls it
        return (time_ms(lambda: torch._int_mm(a8, w8), reps=reps),
                graph_ms(lambda: torch._int_mm(a8, w8), reps))
    except RuntimeError as e:
        log(f"[time] torch._int_mm refused {m}x{k}x{wt.shape[0]}: {e}")
        return None, None


def kernel_row(shape, fn, plain, cost, lib, reps, plain_reps=2):
    """One timing row of the conv or matmul kernel: ``ms``, the CUDA-event
    wall time of back-to-back calls (the other kernels' measure), and
    ``device_ms`` (``graph_ms``: many of these launches are shorter than the
    wrapper's host work, which the wall time includes); the plain version,
    the bound, the rates and bound share on the device time, and
    ``torch._int_mm`` both ways (``lib`` from ``int_mm_ms``)."""
    b_ms, b_by = bound(*cost)
    row = dict(shape=shape, ms=time_ms(fn, reps=reps), device_ms=graph_ms(fn, reps),
               plain_ms=time_ms(plain, reps=plain_reps, warmup=1), bound_ms=b_ms, bound_by=b_by,
               library_ms=lib[0], library_device_ms=lib[1])
    row.update(rates(*cost, row["device_ms"], b_ms))
    return row


def row_text(r) -> str:
    lib = "n/a" if r["library_ms"] is None else (
        f"{r['library_ms']:.4f} wall, {r['library_device_ms']:.4f} device")
    return (f"{r['ms']:.4f} ms wall, {r['device_ms']:.4f} device, {rates_text(r)} on the device "
            f"time (bound {r['bound_ms']:.4f} {r['bound_by']}, plain {r['plain_ms']:.3f}, "
            f"_int_mm {lib})")


def check_gan_matmuls(pred, images, dev):
    """Phase 11, the matmul kernel at the GAN's im2col convs (the stem and
    the strided downs): on the inputs one forward gives it, and at the same
    shapes on an fbgemm grid (per-channel scales, qmax 127) with and without
    ReLU, each output spread over more than 32 codes."""
    calls = capture_convs(pred, images, "im2col")
    if len(calls) != GAN_LAUNCHES["int8_matmul_requant"]:
        raise AssertionError(f"{len(calls)} im2col convs in a GAN forward, expected "
                             f"{GAN_LAUNCHES['int8_matmul_requant']}")
    err, shapes = 0, []
    for i, (name, mod, x) in enumerate(calls):
        a, op = matmul_operand(mod, x), mod._op
        err = max(err, check_equal(f"int8_matmul_requant gan {name} (fixture)",
                                   int8_matmul_requant(a, op), int8_matmul_requant_plain(a, op)))
        g = torch.Generator().manual_seed(100 + i)
        qw = op.wt[:, :op.k].t().cpu()
        a127 = torch.randint(0, 128, a.shape, generator=g, dtype=torch.uint8).to(dev)
        # per-channel scales that put the accumulator's spread (a - 60 has a
        # std of ~36.7) at ~40 output steps of 0.021
        col = qw.to(torch.float32).norm(dim=0).clamp_min(1.0)
        comb = (torch.rand(op.n, generator=g) * 0.5 + 0.75) * (40 * 0.021 / 36.7) / col
        for relu in (False, True):
            fb = conv1x1_operands(qw, comb, torch.randn(op.n, generator=g) * 0.05, 60, 0.021,
                                  17, relu, 0, 127, dev)
            got = int8_matmul_requant(a127, fb)
            err = max(err, check_equal(f"int8_matmul_requant gan {name} (fbgemm grid, "
                                       f"relu={relu})", got, int8_matmul_requant_plain(a127, fb)))
            if len(torch.unique(got)) <= 32:
                raise AssertionError(f"int8_matmul_requant gan {name} (fbgemm grid, relu={relu}): "
                                     f"only {len(torch.unique(got))} distinct codes")
        shapes.append((name, tuple(a.shape), op.n))
    return err, shapes


def check_conv_calls(what, calls, dev):
    """The conv kernel against its plain version at each captured call: on
    the forward's input, and at its shape on an fbgemm grid (per-channel
    scales, qmax 127) with and without ReLU. Returns (max error, checks)."""
    err, checked = 0, 0
    for i, (name, mod, x) in enumerate(calls):
        op = mod._op
        err = max(err, check_equal(f"int8_conv {what} {name} (fixture)", conv3x3_s1_int8(x, op),
                                   conv3x3_s1_int8_plain(x, op)))
        g = torch.Generator().manual_seed(i)
        x127 = torch.randint(0, 128, tuple(x.shape), generator=g, dtype=torch.uint8).to(dev)
        qw = op.weight().permute(2, 3, 1, 0).cpu()
        for relu in (False, True):
            fb = conv3x3_operands(qw, torch.rand(op.cout, generator=g) * 2e-5 + 1e-5,
                                  torch.randn(op.cout, generator=g) * 0.05, 60, 0.05, 17,
                                  relu, 0, 127, dev)
            err = max(err, check_equal(f"int8_conv {what} {name} (fbgemm grid, relu={relu})",
                                       conv3x3_s1_int8(x127, fb), conv3x3_s1_int8_plain(x127, fb)))
        checked += 3
    return err, checked


def check_int8_conv(pred, dev):
    """Phase 11: the conv kernel against its plain version."""
    calls = capture_convs(pred, gan_images(0, GAN_BATCH), "dense3x3")
    if len(calls) != GAN_LAUNCHES["int8_conv"]:
        raise AssertionError(f"{len(calls)} dense 3x3 convs in a forward, expected "
                             f"{GAN_LAUNCHES['int8_conv']}")
    err, checked = check_conv_calls("gan", calls, dev)
    g = torch.Generator().manual_seed(99)
    for h, w, cin, cout in ((13, 21, 68, 36), (37, 75, 68, 132)):
        for qmax in (255, 127):
            x = torch.randint(0, qmax + 1, (3, h, w, cin), generator=g, dtype=torch.uint8).to(dev)
            qw = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
            comb = (torch.tensor(3e-5) if qmax == 255 else
                    torch.rand(cout, generator=g) * 3e-5 + 1e-5)
            for relu in (False, True):
                op = conv3x3_operands(qw, comb, torch.randn(cout, generator=g) * 0.1, 101, 0.04, 9,
                                      relu, 0, qmax, dev)
                want = conv3x3_s1_int8_plain(x, op)
                err = max(err, check_equal(f"int8_conv ragged {h}x{w} {cin}->{cout} (qmax {qmax}, "
                                           f"relu={relu})", conv3x3_s1_int8(x, op), want))
                if len(torch.unique(want)) <= 32:
                    raise AssertionError(f"int8_conv ragged {h}x{w}: only "
                                         f"{len(torch.unique(want))} distinct codes")
                checked += 1
    torch.cuda.synchronize()
    return err, checked, [(name, tuple(x.shape), mod._op.cout) for name, mod, x in calls]


def tail_tf32(tail, x):
    """The GAN's float tail (7x7 conv, bias, tanh) on its NHWC input ``x``
    with cuDNN's TF32 allowed: the control that shows the band would catch
    a tail that ran in TF32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        w = tail.kernel.detach().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return torch.tanh(y + tail.bias.detach())


def serve_gan(pred):
    """Phase 12: the GAN main path against the committed JAX reference, with
    cuDNN's TF32 at its default (allowed). Returns (launch counts, the
    output's distance to JAX's, the TF32 control's distance)."""
    ref = np.load(GAN_REFERENCE)
    images = gan_images(int(ref["image_seed"]), GAN_BATCH)
    if tuple(ref["image_shape"]) != images.shape:
        raise AssertionError(f"reference images {tuple(ref['image_shape'])} != {images.shape}")
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("phase 12 runs with cuDNN's TF32 at its default (allowed)")
    tail_in = []
    hook = pred.model.tail.register_forward_hook(lambda m, args, out: tail_in.append(args[0]))
    ops.reset_launch_counts()
    try:
        out, codes = layer_codes(pred, images)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    layers = check_layers("gan", codes, ref)
    if counts != GAN_LAUNCHES:
        raise AssertionError(f"GAN launches per forward {counts} != {GAN_LAUNCHES}")
    out = out.cpu().numpy()
    if out.shape != images.shape or not np.isfinite(out).all():
        raise AssertionError(f"bad GAN output {out.shape}")
    want = ref["output"]
    err = float(np.abs(out[:len(want)] - want).max())
    tf32 = tail_tf32(pred.model.tail, tail_in[0][:len(want)]).cpu().numpy()
    err_tf32 = float(np.abs(tf32 - want).max())
    log(f"[gan] launches per forward: {counts}; codes == JAX reference at {len(layers)} layers "
        f"x {GAN_BATCH} images; output within {err:.3g} of the JAX output (band "
        f"{GAN_TAIL_BAND:g}); the tail in TF32 would be {err_tf32:.3g} from it")
    if not err <= GAN_TAIL_BAND:
        raise AssertionError(f"GAN output {err} from the JAX output, band {GAN_TAIL_BAND}")
    if not err_tf32 > GAN_TAIL_BAND:
        raise AssertionError(f"the TF32 control ({err_tf32}) passes the band {GAN_TAIL_BAND}: "
                             f"the band cannot tell a TF32 tail")
    return counts, err, err_tf32


GAN_KERNELS = {"int8_conv": "conv3x3_s1_int8", "int8_matmul_requant": "int8_matmul_requant"}
FROSTNET_KERNELS = {"frost_block_int8": "frost_block_kernel",
                    "int8_matmul_requant": "int8_matmul_requant"}


def profile_forward(pred, x, kernels):
    """One profiled forward: device ms and launches of each of ``kernels``
    (name -> a substring of its CUDA kernel's name) and of the torch ops
    (and the torch ops' largest kernels), and the device's idle share."""
    pred(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred(x)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    split = {k: [0.0, 0] for k in list(kernels) + ["torch ops"]}
    by_name = {}
    for e in events:
        key = next((k for k, sub in kernels.items() if sub in e.name), "torch ops")
        ms = e.time_range.elapsed_us() / 1e3
        split[key][0] += ms
        split[key][1] += 1
        if key == "torch ops":
            top = by_name.setdefault(e.name[:90], [0.0, 0])
            top[0] += ms
            top[1] += 1
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) / 1e3
    busy = sum(v[0] for v in split.values())
    return {"device_ms": {k: v[0] for k, v in split.items()},
            "launches": {k: v[1] for k, v in split.items()},
            "busy_ms": busy, "window_ms": window, "idle_share": 1.0 - busy / window,
            "torch_ops_top": sorted(([n, v[0], v[1]] for n, v in by_name.items()),
                                    key=lambda r: -r[1])[:8]}


def time_gan(pred, dev):
    """Phase 13: the conv kernel per shape at batch 8, the matmul kernel at
    the GAN's im2col convs, serving, a profile."""
    rows, mm_rows = [], []
    x8 = gan_images(1, 8)
    for name, mod, x in capture_convs(pred, x8, "dense3x3"):
        op = mod._op
        a = mod.matmul_input(x)
        a = a.reshape(-1, a.shape[-1])
        wt = torch.nn.functional.pad(op.weight().permute(0, 2, 3, 1).reshape(op.cout, -1),
                                     (0, a.shape[1] - 9 * op.cin))  # (Cout, K), (dy, dx, c)
        lib = int_mm_ms(a, wt, reps=20)
        del a
        b, h, w, cin = x.shape
        rows.append(kernel_row(f"{name} {b}x{h}x{w}x{cin}->{op.cout}",
                               lambda: conv3x3_s1_int8(x, op), lambda: conv3x3_s1_int8_plain(x, op),
                               conv3x3_cost(tuple(x.shape), op.cout), lib, reps=20))
        log(f"[time] int8_conv {rows[-1]['shape']}: {row_text(rows[-1])}")
    for name, mod, x in capture_convs(pred, x8, "im2col"):
        a, op = matmul_operand(mod, x), mod._op
        mm_rows.append(kernel_row(f"gan {name} {matmul_shape(a, op)}",
                                  lambda: int8_matmul_requant(a, op),
                                  lambda: int8_matmul_requant_plain(a, op),
                                  matmul_cost(a.shape[0], op.k, op.n),
                                  int_mm_ms(a, op.wt, reps=20), reps=20))
        mm_rows[-1]["path"] = "gan"
        log(f"[time] int8_matmul_requant {mm_rows[-1]['shape']}: {row_text(mm_rows[-1])}")
    throughput = {}
    for b in (1, 8, 16):
        xb = torch.as_tensor(gan_images(2, b), device=dev)
        ms = time_ms(lambda: pred(xb), reps=10 if b < 16 else 5, warmup=1)
        throughput[f"bs{b}"] = {"ms_per_batch": ms, "images_per_sec": b / ms * 1e3}
        log(f"[time] GAN serving batch {b}: {ms:.3f} ms/batch, {b / ms * 1e3:.1f} images/s")
    prof = profile_forward(pred, torch.as_tensor(gan_images(3, 8), device=dev), GAN_KERNELS)
    log_profile("GAN forward at batch 8", prof)
    return rows, mm_rows, throughput, prof


def log_profile(what, prof):
    log(f"[time] {what}, device ms: " + ", ".join(
        f"{k} {v:.3f} ({prof['launches'][k]} launches)" for k, v in prof["device_ms"].items())
        + f"; busy {prof['busy_ms']:.3f} of a {prof['window_ms']:.3f} ms window "
        f"(idle {100 * prof['idle_share']:.1f}%)")
    for name, ms, n in prof["torch_ops_top"]:
        log(f"    torch op {ms:.3f} ms x{n} {name}")


TRAINER_DIR = os.path.join(ROOT, "build", "phase14")
TRAINER_CFG = dict(model=MODEL, image_size=IMAGE, num_classes=CLASSES, dataset="synthetic",
                   batch_size=64, steps_per_epoch=4, fp_epochs=1, epochs=2, optim="QSGD",
                   lrsch="cos_lr", ema_decay=0.9999, log_every=1, device="cuda")


class StepCounter:
    """Wraps a trainer's step factories (``make_train_step`` and
    ``make_eval_step``, or the names given): each step's kernel launches and
    host wall time, by mode."""

    def __init__(self, module, train="make_train_step", eval="make_eval_step"):
        self.mod, self.rows, self.names = module, [], (train, eval)
        self.train, self.eval = getattr(module, train), getattr(module, eval)

    def _wrap(self, make, kind):
        def factory(mode, *args, **kwargs):
            step = make(mode, *args, **kwargs)

            def run(state, batch):
                before = ops.launch_counts()
                t0 = time.perf_counter()
                out = step(state, batch)
                after = ops.launch_counts()
                self.rows.append({"kind": kind, "mode": mode, "ms": (time.perf_counter() - t0)
                                  * 1e3, **{k: after[k] - before[k] for k in after}})
                return out
            return run
        return factory

    def __enter__(self):
        setattr(self.mod, self.names[0], self._wrap(self.train, "train"))
        setattr(self.mod, self.names[1], self._wrap(self.eval, "eval"))
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.names[0], self.train)
        setattr(self.mod, self.names[1], self.eval)


MODE_NAMES = {FP32: "FP32", QAT: "QAT", QAT_FROZEN: "QAT_FROZEN", INT8: "INT8"}
# each trainer step's launches, by (step kind, mode)
STEP_LAUNCHES = {("train", FP32): {"fake_quant_observe": 0, "int8_matmul_requant": 0},
                 ("train", QAT): {"fake_quant_observe": N_SITES, "int8_matmul_requant": 0},
                 ("eval", QAT_FROZEN): {"fake_quant_observe": N_SITES, "int8_matmul_requant": 0},
                 ("eval", INT8): {"fake_quant_observe": 0, "int8_matmul_requant": 52}}


def check_step_launches(rows, what, expect=None):
    """Each step's launches against ``expect`` (``STEP_LAUNCHES`` by
    default); returns the number of steps of each kind and mode."""
    expect = expect or STEP_LAUNCHES
    seen = {}
    for r in rows:
        exp = expect[(r["kind"], r["mode"])]
        got = {k: r[k] for k in exp}
        if got != exp or any(r[k] for k in ops.KERNELS if k not in exp):
            raise AssertionError(f"{what}: {r['kind']} {MODE_NAMES[r['mode']]} launched {got} "
                                 f"!= {exp}")
        key = f"{r['kind']} {MODE_NAMES[r['mode']]}"
        seen[key] = seen.get(key, 0) + 1
    return seen


def check_history(history, what):
    """Every logged loss finite; a line per epoch with images/s and step walls."""
    out = []
    for h in history:
        losses = [h["loss"]] + ([h["val"]["loss"]] if "val" in h else [])
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{what}: {h['tag']} epoch {h['epoch']} loss {losses}")
        rec = {"tag": h["tag"], "epoch": h["epoch"], "loss": h["loss"],
               "images_per_sec": h["images_per_sec"], "step_ms": h["step_ms"]}
        if "val" in h:
            rec["val"] = {k: h["val"][k] for k in ("loss", "top1", "images_per_sec")}
        out.append(rec)
        val = (f"; val loss {h['val']['loss']:.4f}, {h['val']['images_per_sec']:.1f} images/s"
               if "val" in h else "")
        log(f"[trainer] {what} {h['tag']} epoch {h['epoch']}: loss {h['loss']:.4f}, "
            f"{h['images_per_sec']:.1f} images/s, step wall ms "
            f"{[round(t, 1) for t in h['step_ms']]}{val}")
    return out


def trainer_phase(dev):
    """Phase 14: the classification trainer, its resume, the evaluator and
    the served export, through their entry points. Returns (report, launch
    counts of the phase)."""
    from frostnet_tpu_torch.optim import get_lr_scheduler
    from frostnet_tpu_torch.train import classification, evaluate as evaluator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[trainer] TF32 off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False): float32, as the JAX trainer computes")
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    save_dir = os.path.join(TRAINER_DIR, "run")
    rep = {}
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    # 1. train: FP32 epoch, two QAT epochs, validation, checkpoints
    cfg = classification.ClassificationConfig(save_dir=save_dir, **TRAINER_CFG)
    with StepCounter(classification) as counter:
        _, res = classification.main(cfg)
    rep["train_steps"] = check_step_launches(counter.rows, "train run")
    rep["train_history"] = check_history(res["history"], "train run")
    for name in ("checkpoint", "best"):
        if not os.path.exists(os.path.join(save_dir, name, "state.pt")):
            raise AssertionError(f"{name}/ was not written")
    with open(os.path.join(save_dir, "checkpoint_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    logged = [v for r in records for k, v in r.items() if k.endswith("/loss")]
    if not logged or not all(np.isfinite(logged)) or meta["qat_epoch"] != 2:
        raise AssertionError(f"metrics.jsonl losses {logged}, meta {meta}")
    rep["final"] = {"qat": res["qat"], "int8": res["int8"]}
    log(f"[trainer] wrote checkpoint/, best/, checkpoint_meta.json {meta}, metrics.jsonl "
        f"({len(records)} records, {len(logged)} losses, all finite); steps per mode "
        f"{rep['train_steps']}: fake_quant_observe 0 per FP32 step, {N_SITES} per QAT step "
        f"and per QAT_FROZEN forward, int8_matmul_requant 52 per INT8 forward")
    log(f"[trainer] final QAT_FROZEN {res['qat']}; INT8 {res['int8']}")

    # 2. resume into a third QAT epoch
    saved = torch.load(os.path.join(save_dir, "checkpoint", "state.pt"), map_location="cpu",
                       weights_only=False)["optimizer"]["noise_generator"]
    cfg = classification.ClassificationConfig(save_dir=save_dir, resume=True,
                                              **{**TRAINER_CFG, "epochs": 3})
    with StepCounter(classification) as counter:
        _, res = classification.main(cfg)
    got = res["resumed"]
    want_lr = get_lr_scheduler("cos_lr", base_lr=cfg.learning_rate, total_steps=16,
                               warmup_steps=0, warmup_lr=cfg.warmup_lr)(12)
    if (got["qat_epoch"], got["step"], got["count"]) != (2, 12, 12) or got["lr"] != want_lr:
        raise AssertionError(f"resume: {got} (want QAT epoch 2, step 12, count 12, lr {want_lr})")
    if saved is None or got["noise_generator"] is None or not torch.equal(
            got["noise_generator"], saved):
        raise AssertionError("resume: the noise generator's state != the saved one")
    rep["resume_steps"] = check_step_launches(counter.rows, "resume")
    rep["resume_history"] = check_history(res["history"], "resume")
    rep["resumed"] = {k: v for k, v in got.items() if k != "noise_generator"}
    log(f"[trainer] resumed at QAT epoch {got['qat_epoch']}, step {got['step']}, count "
        f"{got['count']}: first update at cos_lr(12 of 16) = {got['lr']!r}; noise generator "
        f"state == saved ({saved.numel()} bytes)")

    # 3. the evaluator on best/, the EMA swapped in, recalibrated, exported
    artifact = os.path.join(TRAINER_DIR, "int8.npz")
    args = evaluator.build_parser([]).parse_args(
        ["--model", MODEL, "--checkpoint", os.path.join(save_dir, "best"), "--num_classes",
         str(CLASSES), "--image_size", str(IMAGE), "--batch_size", "64", "--calib_batches", "2",
         "--use_ema", "--export_int8", artifact, "--device", "cuda"])
    with StepCounter(classification) as counter:  # evaluate() is the trainer's
        ev = evaluator.main(args)
    rep["evaluate_steps"] = check_step_launches(counter.rows, "evaluate")
    if not all(np.isfinite([ev["qat"]["loss"], ev["int8"]["loss"]])):
        raise AssertionError(f"evaluate: {ev['qat']} {ev['int8']}")
    rep["evaluate"] = {"qat": ev["qat"], "int8": ev["int8"], "int8_size_mb": ev["int8_size_mb"],
                       "export_bytes": ev["export_bytes"]}
    log(f"[trainer] evaluate.main: QAT_FROZEN {ev['qat']}, INT8 {ev['int8']}, INT8 size "
        f"{ev['int8_size_mb']:.2f} MB, artifact {ev['export_bytes']} bytes")

    # 4. serve the exported artifact, unfused and fused, against the
    # in-process freeze of the evaluator's model
    port = create_model(MODEL, num_classes=CLASSES)
    port.load_state_dict(ev["state"].model.state_dict())
    serve_batch = 8
    images = np.random.RandomState(0).randn(serve_batch, IMAGE, IMAGE, 3).astype(np.float32)
    want = freeze(port, dev, IMAGE)(images).cpu().numpy()
    served = {}
    for fuse in (False, True):
        out = os.path.join(TRAINER_DIR, f"logits_{'fused' if fuse else 'unfused'}.npy")
        argv = ["--artifact", artifact, "--iters", "5", "--batch_size", str(serve_batch),
                "--save_logits", out] + (["--fuse_int8"] if fuse else [])
        served[fuse] = serve.main(serve.build_parser().parse_args(argv))
        got = np.load(out)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"served {'fused' if fuse else 'unfused'} logits != in-process "
                                 f"freeze (max abs diff {np.abs(got - want).max()})")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    rep["serve"] = {("fused" if k else "unfused"): v for k, v in served.items()}
    rep["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[trainer] serve.main on the exported artifact, unfused and fused: logits == the "
        f"in-process freeze of the evaluator's model, bit for bit ({len(np.unique(want))} "
        f"distinct values); peak memory {rep['peak_memory_gib']:.2f} GiB; launches over "
        f"phase 14 {counts}")
    for name in ("fake_quant_observe", "int8_matmul_requant", "frost_block_int8"):
        if counts[name] == 0:
            raise AssertionError(f"phase 14 launched no {name}")
    return rep, counts


MOBILENETS = ("qmobilenet_v2_ReLU", "qmobilenet_v3_large_HS")
PHASE15_DIR = os.path.join(ROOT, "build", "phase15")
# MobileNetV3's INT8 codes against the JAX digests: the squeeze-excite's
# spatial mean (XLA: a sequential float32 sum; the port: exact, rounded
# once) and its dense products decide rare codes after the gating mul's
# requant. Every code matched on the CPU (tests/test_torch_mobilenet_fixture.py,
# 8 images); a layer whose digest differs passes only if its 256-code
# histogram moves by at most this share of its codes, and the logits
# (cls_conv2's grid) by at most one step.
MB_FLIP_SHARE = 1e-3
MB_KERNELS = {"int8_matmul_requant": "int8_matmul_requant"}


def matmul_convs(model):
    """The convs of a frozen model that run the matmul kernel (1x1 and im2col)."""
    return [m for m in model.modules()
            if isinstance(m, QConvBNAct) and getattr(m, "_route", None) in ("matmul", "im2col")]


def observers(model) -> int:
    """Per-tensor sites of a qnnpack model: one fake-quant launch each a QAT forward."""
    return sum(isinstance(m, Observer) for m in model.modules())


def check_mobilenet_layers(name, codes, ref, banded):
    """Every layer's digests against the JAX reference; where ``banded``, a
    differing layer within ``MB_FLIP_SHARE`` of its codes (histogram)."""
    layers = [k[len("sha256/"):] for k in ref.files if k.startswith("sha256/")]
    moved = {}
    for layer in layers:
        got = codes.get(layer)
        if got is None or tuple(got.shape) != tuple(ref[f"shape/{layer}"]):
            raise AssertionError(f"{name} {layer}: shape {None if got is None else tuple(got.shape)}")
        images = [i for i, (g, w) in enumerate(zip(code_digests(got), ref[f"sha256/{layer}"]))
                  if g != w]
        if not images:
            continue
        hist = torch.bincount(got.reshape(-1).to(torch.int64).cpu(), minlength=256).numpy()
        share = float(np.abs(hist - ref[f"hist/{layer}"]).sum() / 2 / got.numel())
        moved[layer] = {"images": images, "hist_share": share}
        if not banded or share > MB_FLIP_SHARE:
            raise AssertionError(f"{name}: codes differ from the JAX reference at {layer} "
                                 f"(images {images}, histogram share {share:.3g})")
    return layers, moved


def check_mobilenet_matmuls(name, pred, x, dev):
    """The matmul kernel against its plain version at every INT8 matmul of
    one forward, on the inputs that forward gives it, and on the same input
    one byte into its storage (no row 16-byte aligned)."""
    err, shapes = 0, []
    for cname, mod, inp in capture(pred.model, x):
        if mod._route not in ("matmul", "im2col"):
            continue
        a, op = matmul_operand(mod, inp.q), mod._op
        want = int8_matmul_requant_plain(a, op)
        err = max(err, check_equal(f"int8_matmul_requant {name} {cname}", int8_matmul_requant(a, op),
                                   want))
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
        shifted = buf[1:].view(a.shape)
        shifted.copy_(a)
        err = max(err, check_equal(f"int8_matmul_requant {name} {cname} (unaligned rows)",
                                   int8_matmul_requant(shifted, op), want))
        shapes.append(matmul_shape(a, op))
    torch.cuda.synchronize()
    return err, shapes


def serve_mobilenets(dev):
    """Phase 15, part 1: serve each fixture at batch 8 through
    ``Int8Predictor``: every layer's codes and the logits against the JAX
    reference, the matmul launches per forward against the model's count,
    the matmul kernel against its plain version at every INT8 matmul."""
    images = np.random.RandomState(0).randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    x = torch.as_tensor(images, device=dev)
    out, preds, err = {}, {}, 0
    for name in MOBILENETS:
        ref = np.load(os.path.join(TESTDATA, f"{name}_reference.npz"))
        pred = preds[name] = mobilenet_predictor(name, dev, PHASE15_DIR)
        n_mm = len(matmul_convs(pred.model))
        ops.reset_launch_counts()
        logits, codes = layer_codes(pred, images)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expect = {"int8_matmul_requant": n_mm, "frost_block_int8": 0, "fake_quant_observe": 0,
                  "int8_conv": 0}
        if counts != expect:
            raise AssertionError(f"{name}: launches per forward {counts} != {expect}")
        v3 = "v3" in name
        layers, moved = check_mobilenet_layers(name, codes, ref, banded=v3)
        got, want = logits.cpu().numpy(), ref["logits"]
        if got.shape != (BATCH, CLASSES) or not np.isfinite(got).all():
            raise AssertionError(f"{name}: bad logits {got.shape}")
        head = pred.model.classifier if not v3 else pred.model.cls_conv2
        step = float(head._out_t[0])
        diff = float(np.abs(got - want).max())
        if diff > (step * 1.0001 if (not v3 or moved) else 0.0):
            raise AssertionError(f"{name}: logits {diff} from JAX's (grid step {step})")
        e, shapes = check_mobilenet_matmuls(name, pred, x, dev)
        err = max(err, e)
        out[name] = {"launches": counts, "layers": len(layers), "moved": moved,
                     "logits_max_diff": diff, "logits_step": step,
                     "logits_equal": bool(np.array_equal(got, want)),
                     "matmul_shapes": shapes}
        log(f"[mobilenet] {name} served at batch {BATCH}: launches per forward {counts}; codes "
            f"== JAX reference at {len(layers) - len(moved)} of {len(layers)} layers x {BATCH} "
            f"images{f' (band: {moved})' if moved else ''}; logits {diff:.3g} from JAX's "
            f"(grid step {step:.4g}, equal: {out[name]['logits_equal']}); matmul == plain at "
            f"{len(shapes)} shapes, aligned and unaligned rows: {sorted(set(shapes))}")
    return out, preds, err


def check_mobilenet_fake_quant(dev):
    """Phase 15, part 2: the fake-quant kernel against its plain version at
    every per-tensor site of two full-width qmobilenet_v3_large_HS QAT
    forwards (fresh observers, then calibrated), float32 and bfloat16,
    with the QAT_FROZEN pass."""
    name = MOBILENETS[1]
    model = create_model(name, num_classes=CLASSES, drop_rate=0.0)
    from_jax_variables(model, numpy_init(model, 0)).to(dev)
    n_sites = observers(model)
    checked, err, shapes = 0, 0.0, set()
    for k in range(2):
        sites = capture_sites(model, prep_image(torch.as_tensor(train_batch(k)["image"],
                                                                device=dev)), QAT)
        if len(sites) != n_sites:
            raise AssertionError(f"{name}: {len(sites)} per-tensor sites in a QAT forward, "
                                 f"expected {n_sites}")
        for i, (x, mn, mx, spec) in enumerate(sites):
            shapes.add(tuple(x.shape))
            for dt in (torch.float32, torch.bfloat16):
                err = max(err, check_site(f"{name} forward {k} site {i} {tuple(x.shape)} {dt}",
                                          x.to(dt), mn, mx, spec))
                checked += 1
    torch.cuda.synchronize()
    return checked, err, n_sites, len(shapes)


MB_TRAINER_CFG = dict(model=MOBILENETS[1], image_size=IMAGE, num_classes=CLASSES,
                      dataset="synthetic", batch_size=64, steps_per_epoch=2, fp_epochs=1,
                      epochs=1, optim="QSGD", lrsch="cos_lr", log_every=1, device="cuda")


def dense_convs(model):
    """The convs of a frozen model that run the dense 3x3 conv kernel."""
    return [m for m in model.modules()
            if isinstance(m, QConvBNAct) and getattr(m, "_route", None) == "dense3x3"]


def trainer_path(dev, run_cfg, root, what="mobilenet"):
    """``classification.main`` with ``run_cfg`` (one FP32 and one QAT
    epoch), ``evaluate.main --export_int8`` on ``best/``, ``serve.main`` on
    the artifact: its logits equal the in-process freeze of the evaluator's
    model bit for bit; each step's launches as the model's sites and INT8
    routes say (phase 15, part 4, and phase 16, part 5)."""
    from frostnet_tpu_torch.train import classification, evaluate as evaluator

    name = run_cfg["model"]
    shutil.rmtree(root, ignore_errors=True)
    save_dir = os.path.join(root, "run")
    probe = create_model(name, num_classes=CLASSES)
    n_sites = observers(probe)
    probe.prepare_int8("cpu", IMAGE)
    n_mm, n_conv = len(matmul_convs(probe)), len(dense_convs(probe))
    zero = {"fake_quant_observe": 0, "int8_matmul_requant": 0, "int8_conv": 0}
    expect = {("train", FP32): zero,
              ("train", QAT): {**zero, "fake_quant_observe": n_sites},
              ("eval", QAT_FROZEN): {**zero, "fake_quant_observe": n_sites},
              ("eval", INT8): {**zero, "int8_matmul_requant": n_mm, "int8_conv": n_conv}}
    rep = {}
    torch.cuda.reset_peak_memory_stats()
    cfg = classification.ClassificationConfig(save_dir=save_dir, **run_cfg)
    with StepCounter(classification) as counter:
        _, res = classification.main(cfg)
    rep["train_steps"] = check_step_launches(counter.rows, f"{name} train run", expect)
    rep["train_history"] = check_history(res["history"], f"{name} train run")
    rep["final"] = {"qat": res["qat"], "int8": res["int8"]}
    for f in ("checkpoint", "best", "checkpoint_meta.json", "metrics.jsonl"):
        if not os.path.exists(os.path.join(save_dir, f)):
            raise AssertionError(f"{name} trainer: {f} was not written")
    artifact = os.path.join(root, "int8.npz")
    args = evaluator.build_parser([]).parse_args(
        ["--model", name, "--checkpoint", os.path.join(save_dir, "best"), "--num_classes",
         str(CLASSES), "--image_size", str(IMAGE), "--batch_size", "64", "--calib_batches", "2",
         "--export_int8", artifact, "--device", "cuda"])
    with StepCounter(classification) as counter:
        ev = evaluator.main(args)
    rep["evaluate_steps"] = check_step_launches(counter.rows, f"{name} evaluate", expect)
    if not all(np.isfinite([ev["qat"]["loss"], ev["int8"]["loss"]])):
        raise AssertionError(f"{name} evaluate: {ev['qat']} {ev['int8']}")
    rep["evaluate"] = {"qat": ev["qat"], "int8": ev["int8"], "export_bytes": ev["export_bytes"]}
    port = create_model(name, num_classes=CLASSES)
    port.load_state_dict(ev["state"].model.state_dict())
    images = np.random.RandomState(0).randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    want = freeze(port, dev, IMAGE)(images).cpu().numpy()
    out = os.path.join(root, "logits.npy")
    rep["serve"] = serve.main(serve.build_parser().parse_args(
        ["--model", name, "--artifact", artifact, "--iters", "5", "--batch_size", str(BATCH),
         "--save_logits", out]))
    got = np.load(out)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{name}: served logits != in-process freeze (max abs diff "
                             f"{np.abs(got - want).max()})")
    rep["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{what}] trainer {name}: steps per mode {rep['train_steps']} (fake_quant_observe "
        f"0 per FP32 step, {n_sites} per QAT step and QAT_FROZEN forward; int8_matmul_requant "
        f"{n_mm} and int8_conv {n_conv} per INT8 forward); evaluate.main QAT_FROZEN "
        f"{ev['qat']}, INT8 {ev['int8']}; "
        f"serve.main on its artifact == in-process freeze bit for bit "
        f"({len(np.unique(want))} distinct values); peak memory {rep['peak_memory_gib']:.2f} GiB")
    return rep


def group_inputs(model, x):
    """``{group: [(module, input)]}`` of one INT8 forward: the depthwise
    convs (torch ops), the hard-swishes and the squeeze-excites."""
    groups, hooks = {"depthwise": [], "hswish": [], "se": []}, []

    def keep(group):
        return lambda m, args, out: groups[group].append((m, args[0]))

    for mod in model.modules():
        if isinstance(mod, QConvBNAct) and getattr(mod, "_route", None) == "depthwise":
            hooks.append(mod.register_forward_hook(keep("depthwise")))
        elif isinstance(mod, QHswish):
            hooks.append(mod.register_forward_hook(keep("hswish")))
        elif isinstance(mod, QSEModule):
            hooks.append(mod.register_forward_hook(keep("se")))
    try:
        with torch.inference_mode():
            model(x, mode=INT8)
    finally:
        for h in hooks:
            h.remove()
    return groups


def time_mobilenets(preds, dev):
    """Phase 15, part 5: serving images/s at batch 8 and 128, one profiled
    forward at batch 8 (the matmul kernel, the torch ops, the device's idle
    share), and the device time of each torch-op group (a CUDA graph of the
    group's calls on that forward's inputs, replayed)."""
    out = {}
    for name, pred in preds.items():
        rec = {}
        for b in (8, 128):
            xb = torch.as_tensor(np.random.RandomState(1).randn(b, IMAGE, IMAGE, 3)
                                 .astype(np.float32), device=dev)
            ms = time_ms(lambda: pred(xb), reps=10 if b == 8 else 5, warmup=1)
            rec[f"bs{b}"] = {"ms_per_batch": ms, "images_per_sec": b / ms * 1e3}
            log(f"[time] {name} serving batch {b}: {ms:.3f} ms/batch, {b / ms * 1e3:.1f} images/s")
        x8 = torch.as_tensor(np.random.RandomState(2).randn(BATCH, IMAGE, IMAGE, 3)
                             .astype(np.float32), device=dev)
        try:
            rec["profile"] = profile_forward(pred, x8, MB_KERNELS)
            log_profile(f"{name} forward at batch {BATCH}", rec["profile"])
        except RuntimeError as e:  # torch.profiler stops recording after many sessions
            log(f"[time] {name}: no profile ({e})")
            rec["profile"] = None
        groups = {}
        with torch.inference_mode():
            for group, calls in group_inputs(pred.model, x8).items():
                if not calls:
                    continue

                def run(calls=calls):
                    return [m(x, INT8) for m, x in calls]

                groups[group] = {"modules": len(calls), "device_ms": graph_ms(run, 5),
                                 "wall_ms": time_ms(run, reps=5)}
        rec["groups"] = groups
        log(f"[time] {name} torch-op groups at batch {BATCH}, ms device (CUDA graph) / wall: "
            + ", ".join(f"{g} {v['device_ms']:.4f} / {v['wall_ms']:.4f} ({v['modules']} modules)"
                        for g, v in groups.items()))
        out[name] = rec
    return out


def mobilenet_phase(dev):
    """Phase 15: the MobileNets on the card (serving, the fake-quant sites,
    training, the user's path, serving speed). Returns (report, launches of
    each path)."""
    rep, launches = {}, {}
    os.makedirs(PHASE15_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    rep["serving"], preds, rep["matmul_max_abs_err"] = serve_mobilenets(dev)
    launches["serving"] = {n: r["launches"] for n, r in rep["serving"].items()}
    checked, rep["fake_quant_max_abs_err"], n_sites, n_shapes = check_mobilenet_fake_quant(dev)
    log(f"[mobilenet] fake_quant_observe == plain at {checked} site checks (2 QAT forwards of "
        f"{MOBILENETS[1]} x {n_sites} sites x float32/bfloat16, {n_shapes} shapes; QAT and "
        f"QAT_FROZEN passes)")
    rep["fake_quant_site_checks"] = checked
    training = {}
    for name in MOBILENETS:
        sites = observers(create_model(name))
        ops.reset_launch_counts()
        training[name] = time_training(dev, name, time_sites=False, reps=(3, 5))
        counts = ops.launch_counts()
        for b, r in training[name].items():
            if r.get("fits", True) and (r["qat_fake_quant_launches"], r["fp32_fake_quant_launches"]) \
                    != (sites, 0):
                raise AssertionError(f"{name} {b}: fake-quant launches per QAT / FP32 step "
                                     f"{r['qat_fake_quant_launches']} / "
                                     f"{r['fp32_fake_quant_launches']} != {sites} / 0")
        if counts["fake_quant_observe"] == 0:
            raise AssertionError(f"{name} training launched no fake-quant kernel")
        launches[f"training {name}"] = counts
        torch.cuda.empty_cache()
    rep["training"] = training
    ops.reset_launch_counts()
    rep["trainer"] = trainer_path(dev, MB_TRAINER_CFG, os.path.join(PHASE15_DIR, "trainer"))
    launches["trainer"] = ops.launch_counts()
    for k in ("fake_quant_observe", "int8_matmul_requant"):
        if launches["trainer"][k] == 0:
            raise AssertionError(f"phase 15's trainer path launched no {k}")
    rep["timing"] = time_mobilenets(preds, dev)
    del preds
    torch.cuda.empty_cache()
    return rep, launches


RESNETS = ("qresnet18", "qresnet50")
PHASE16_DIR = os.path.join(ROOT, "build", "phase16")
# launches of one INT8 forward (read from the JAX modules): the
# non-strided 3x3s on the dense conv kernel; the stem, the strided 3x3s, the
# 1x1s and the downsamples on the matmul kernel
RESNET_LAUNCHES = {"qresnet18": {"int8_matmul_requant": 7, "frost_block_int8": 0,
                                 "fake_quant_observe": 0, "int8_conv": 13},
                   "qresnet50": {"int8_matmul_requant": 40, "frost_block_int8": 0,
                                 "fake_quant_observe": 0, "int8_conv": 13}}
RESNET_SITES = {"qresnet18": 51, "qresnet50": 125}
RESNET_KERNELS = {"int8_conv": "conv3x3_s1_int8", "int8_matmul_requant": "int8_matmul_requant"}
# ResNeXt-101 32x8d's grouped 3x3s, one per stage: (H in, width, stride)
RESNEXT_GROUPED = [(56, 256, 1), (56, 512, 2), (28, 1024, 2), (14, 2048, 2)]
RESNET_TRAINER_CFG = dict(model="qresnet18", image_size=IMAGE, num_classes=CLASSES,
                          dataset="synthetic", batch_size=64, steps_per_epoch=2, fp_epochs=1,
                          epochs=1, optim="QSGD", lrsch="cos_lr", log_every=1, device="cuda")


def serve_resnets(dev):
    """Phase 16, part 1: serve each ResNet fixture at batch 8 through
    ``Int8Predictor``: every layer's codes against the JAX digests, the
    logits against JAX's (bit-equal, or within one step of the ``fc``
    output grid), the launches of one forward; then the dense conv kernel
    at each of the forward's dense convs (its inputs, and an fbgemm grid)
    and the matmul kernel at each of its matmuls (aligned and unaligned
    rows), against their plain versions."""
    images = np.random.RandomState(0).randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    x = torch.as_tensor(images, device=dev)
    out, preds, err = {}, {}, {"int8_conv": 0, "int8_matmul_requant": 0}
    for name in RESNETS:
        ref = np.load(os.path.join(TESTDATA, f"{name}_reference.npz"))
        pred = preds[name] = mobilenet_predictor(name, dev, PHASE16_DIR)
        ops.reset_launch_counts()
        logits, codes = layer_codes(pred, images)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts != RESNET_LAUNCHES[name]:
            raise AssertionError(f"{name}: launches per forward {counts} != "
                                 f"{RESNET_LAUNCHES[name]}")
        layers, _ = check_mobilenet_layers(name, codes, ref, banded=False)
        got, want = logits.cpu().numpy(), ref["logits"][:BATCH]
        if got.shape != (BATCH, CLASSES) or not np.isfinite(got).all():
            raise AssertionError(f"{name}: bad logits {got.shape}")
        step = float(pred.model.fc._out_t[0])
        diff = float(np.abs(got - want).max())
        if diff > step * 1.0001:
            raise AssertionError(f"{name}: logits {diff} from JAX's (fc grid step {step})")
        convs = [(c, m, inp.q) for c, m, inp in capture(pred.model, x) if m._route == "dense3x3"]
        e, n_conv = check_conv_calls(name, convs, dev)
        err["int8_conv"] = max(err["int8_conv"], e)
        e, shapes = check_mobilenet_matmuls(name, pred, x, dev)
        err["int8_matmul_requant"] = max(err["int8_matmul_requant"], e)
        out[name] = {"launches": counts, "layers": len(layers), "logits_max_diff": diff,
                     "logits_step": step, "logits_equal": bool(np.array_equal(got, want)),
                     "conv_checks": n_conv, "conv_shapes": sorted({
                         f"{tuple(q.shape)}->{m._op.cout}" for _, m, q in convs}),
                     "matmul_shapes": shapes}
        log(f"[resnet] {name} served at batch {BATCH}: launches per forward {counts}; codes == "
            f"JAX reference at {len(layers)} layers x {BATCH} images; logits {diff:.3g} from "
            f"JAX's (fc grid step {step:.4g}, equal: {out[name]['logits_equal']}); int8_conv == "
            f"plain at {n_conv} checks ({len(convs)} convs x fixture input, fbgemm grid with and "
            f"without ReLU) {out[name]['conv_shapes']}; matmul == plain at {len(shapes)} "
            f"shapes, aligned and unaligned rows: {sorted(set(shapes))}")
    return out, preds, err


def check_grouped(dev):
    """Phase 16, part 2: the grouped INT8 route (torch ops) at ResNeXt-101
    32x8d's four stage shapes at batch 2, on the card against its CPU
    result, bit for bit."""
    rows = []
    for i, (h, width, stride) in enumerate(RESNEXT_GROUPED):
        g = torch.Generator().manual_seed(200 + i)
        conv = QConvBNAct(width, width, 3, strides=stride, padding=1, groups=32)
        with torch.no_grad():
            conv.kernel.copy_(torch.randn(conv.kernel.shape, generator=g) * (2.0 / 72) ** 0.5)
            conv.bias_bn.copy_(torch.randn(width, generator=g) * 0.3 + 0.2)
            conv.w_obs.min_val.fill_(-0.6)
            conv.w_obs.max_val.fill_(0.6)
            conv.act_obs.min_val.fill_(0.0)
            conv.act_obs.max_val.fill_(4.0)
        x = torch.randint(0, 256, (2, h, h, width), generator=g, dtype=torch.uint8)
        grid = QParams(0.021, 97)
        outs = []
        for d in ("cpu", dev):
            conv.to(d).eval()
            conv.prepare_int8(grid, d)
            outs.append(conv(QTensor(x.to(d), *grid.tensors(d)), mode=INT8).q.cpu())
        if conv._route != "grouped" or not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"grouped route {h}x{h}x{width}/{stride}: card != CPU")
        if len(torch.unique(outs[0])) <= 32:
            raise AssertionError(f"grouped route {h}x{h}x{width}: too few codes")
        rows.append(f"2x{h}x{h}x{width} g32 s{stride}")
    torch.cuda.synchronize()
    return rows


def check_resnet_fake_quant(dev):
    """Phase 16, part 3: the fake-quant kernel against its plain version at
    every per-tensor site of a qresnet50 QAT forward at batch 8, float32 and
    bfloat16, with the QAT_FROZEN pass; then the largest site at batch 256
    in bfloat16 (205.5 M elements: the batch-8 site tiled 32 times, its last
    image scaled by 1.5 so that the extremes lie at the far end)."""
    name = RESNETS[1]
    model = create_model(name, num_classes=CLASSES)
    from_jax_variables(model, numpy_init(model, 0)).to(dev)
    sites = capture_sites(model, prep_image(torch.as_tensor(train_batch(0)["image"], device=dev)),
                          QAT)
    if len(sites) != RESNET_SITES[name]:
        raise AssertionError(f"{name}: {len(sites)} per-tensor sites, expected "
                             f"{RESNET_SITES[name]}")
    checked, err = 0, 0.0
    for i, (x, mn, mx, spec) in enumerate(sites):
        for dt in (torch.float32, torch.bfloat16):
            err = max(err, check_site(f"{name} site {i} {tuple(x.shape)} {dt}", x.to(dt), mn, mx,
                                      spec))
            checked += 1
    x, mn, mx, spec = max(sites, key=lambda s: s[0].numel())
    del sites, model
    torch.cuda.empty_cache()
    big = x.to(torch.bfloat16).repeat(256 // x.shape[0], 1, 1, 1)
    big[-1] *= 1.5
    err = max(err, check_site(f"{name} largest site at batch 256 {tuple(big.shape)} bf16", big,
                              mn, mx, spec))
    shape = tuple(big.shape)
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return checked + 1, err, shape


def time_resnets(preds, dev):
    """Phase 16, part 6: the dense conv at its four ResNet shapes (ReLU,
    batch 8 and 128) and qresnet50's distinct matmul shapes at batch 8, each
    beside its bound, its plain version and ``torch._int_mm``; serving
    images/s at batch 8 and 128; one profiled forward at batch 8."""
    conv_rows, mm_rows, out = [], [], {}
    pred = preds["qresnet50"]
    for b in (8, 128):
        xb = torch.as_tensor(np.random.RandomState(1).randn(b, IMAGE, IMAGE, 3)
                             .astype(np.float32), device=dev)
        seen = set()
        for name, mod, inp in capture(preds["qresnet18"].model, xb):
            x = inp.q
            if mod._route != "dense3x3" or not mod._op.relu or tuple(x.shape) in seen:
                continue
            seen.add(tuple(x.shape))
            op = mod._op
            a = mod.matmul_input(x)
            a = a.reshape(-1, a.shape[-1])
            wt = torch.nn.functional.pad(op.weight().permute(0, 2, 3, 1).reshape(op.cout, -1),
                                         (0, a.shape[1] - 9 * op.cin))  # (Cout, K), (dy, dx, c)
            lib = int_mm_ms(a, wt, reps=10)
            del a
            bb, h, w, cin = x.shape
            conv_rows.append(kernel_row(f"{name} {bb}x{h}x{w}x{cin}->{op.cout}",
                                        lambda: conv3x3_s1_int8(x, op),
                                        lambda: conv3x3_s1_int8_plain(x, op),
                                        conv3x3_cost(tuple(x.shape), op.cout), lib,
                                        reps=20 if b == 8 else 5, plain_reps=1))
            conv_rows[-1]["path"] = f"resnet bs{b}"
            log(f"[time] int8_conv {conv_rows[-1]['shape']}: {row_text(conv_rows[-1])}")
        del xb
    x8 = torch.as_tensor(np.random.RandomState(1).randn(BATCH, IMAGE, IMAGE, 3)
                         .astype(np.float32), device=dev)
    seen = set()
    for name, mod, inp in capture(pred.model, x8):
        if mod._route not in ("matmul", "im2col"):
            continue
        a, op = matmul_operand(mod, inp.q), mod._op
        key = (a.shape[0], op.k, op.n)
        if key in seen:
            continue
        seen.add(key)
        mm_rows.append(kernel_row(f"qresnet50 {name} {matmul_shape(a, op)}",
                                  lambda: int8_matmul_requant(a, op),
                                  lambda: int8_matmul_requant_plain(a, op),
                                  matmul_cost(a.shape[0], op.k, op.n),
                                  int_mm_ms(a, op.wt, reps=20), reps=20, plain_reps=1))
        mm_rows[-1]["path"] = "resnet"
        log(f"[time] int8_matmul_requant {mm_rows[-1]['shape']}: {row_text(mm_rows[-1])}")
    for name, p in preds.items():
        rec = {}
        for b in (8, 128):
            xb = torch.as_tensor(np.random.RandomState(1).randn(b, IMAGE, IMAGE, 3)
                                 .astype(np.float32), device=dev)
            ms = time_ms(lambda: p(xb), reps=10 if b == 8 else 3, warmup=1)
            rec[f"bs{b}"] = {"ms_per_batch": ms, "images_per_sec": b / ms * 1e3}
            log(f"[time] {name} serving batch {b}: {ms:.3f} ms/batch, {b / ms * 1e3:.1f} images/s")
            del xb
        try:
            rec["profile"] = profile_forward(p, x8, RESNET_KERNELS)
            log_profile(f"{name} forward at batch {BATCH}", rec["profile"])
        except RuntimeError as e:  # torch.profiler stops recording after many sessions
            log(f"[time] {name}: no profile ({e})")
            rec["profile"] = None
        out[name] = rec
    return conv_rows, mm_rows, out


def resnet_phase(dev):
    """Phase 16: the ResNets on the card (serving, the kernels at their
    shapes, the grouped route, the fake-quant sites, training, the user's
    path, timings). Returns (report, launches of each path, conv rows,
    matmul rows)."""
    rep, launches = {}, {}
    os.makedirs(PHASE16_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep["serving"], preds, rep["max_abs_err"] = serve_resnets(dev)
    launches["serving"] = {n: r["launches"] for n, r in rep["serving"].items()}
    rep["grouped"] = check_grouped(dev)
    log(f"[resnet] grouped INT8 route (torch ops) on the card == CPU at {rep['grouped']}")
    checked, rep["fake_quant_max_abs_err"], largest = check_resnet_fake_quant(dev)
    rep["fake_quant_site_checks"] = checked
    log(f"[resnet] fake_quant_observe == plain at {checked} site checks ({RESNETS[1]} QAT "
        f"forward x {RESNET_SITES[RESNETS[1]]} sites x float32/bfloat16, QAT and QAT_FROZEN "
        f"passes; the largest site at {largest} bfloat16)")
    training = {}
    for name in RESNETS:
        ops.reset_launch_counts()
        training[name] = time_training(dev, name, time_sites=False, reps=(3, 5))
        counts = ops.launch_counts()
        for b, r in training[name].items():
            got = (r.get("qat_fake_quant_launches"), r.get("fp32_fake_quant_launches"))
            if r.get("fits", True) and got != (RESNET_SITES[name], 0):
                raise AssertionError(f"{name} {b}: fake-quant launches per QAT / FP32 step "
                                     f"{r['qat_fake_quant_launches']} / "
                                     f"{r['fp32_fake_quant_launches']} != "
                                     f"{RESNET_SITES[name]} / 0")
        if counts["fake_quant_observe"] == 0:
            raise AssertionError(f"{name} training launched no fake-quant kernel")
        launches[f"training {name}"] = counts
        torch.cuda.empty_cache()
    rep["training"] = training
    ops.reset_launch_counts()
    rep["trainer"] = trainer_path(dev, RESNET_TRAINER_CFG, os.path.join(PHASE16_DIR, "trainer"),
                                  "resnet")
    launches["trainer"] = ops.launch_counts()
    for k in ("fake_quant_observe", "int8_matmul_requant", "int8_conv"):
        if launches["trainer"][k] == 0:
            raise AssertionError(f"phase 16's trainer path launched no {k}")
    conv_rows, mm_rows, rep["timing"] = time_resnets(preds, dev)
    del preds
    torch.cuda.empty_cache()
    return rep, launches, conv_rows, mm_rows


SEG_MODELS_CHECKED = ("mobilenetv3_RE_small", "mobilenetv3_large")
SEG_CROP, SEG_CLASSES = 768, 19
PHASE17_DIR = os.path.join(ROOT, "build", "phase17")
SEG_TRAIN_REFERENCE = os.path.join(TESTDATA, "seg_mobilenetv3_RE_small_train_reference.npz")
# The segmentation fixtures store the logits at every SEG_LOGIT_STRIDE-th
# pixel. The float tail (two 1x1 convs with a bias, an add, the bilinear
# resize) sums in other orders than XLA's conv: logits within SEG_LOGIT_BAND
# of their range, absolute; the argmax then agrees at all but
# SEG_ARGMAX_SHARE of the pixels (ties at a float ulp). The same bands hold on
# the CPU (tests/test_torch_seg_fixture.py).
SEG_LOGIT_STRIDE, SEG_LOGIT_BAND, SEG_ARGMAX_SHARE = 16, 1e-5, 1e-4
# Where an image's codes move: XLA's squeeze-excite mean and dense products
# sum in their own orders (the port: exactly), so a code on a rounding
# boundary of the gating mul moves (the origin, at a block with a
# squeeze-excite, within MB_FLIP_SHARE), and the next layers carry it; the
# LR-ASPP gate (a 37x37 pool of c4) spreads it over the whole image. On the
# CPU, image 1 of mobilenetv3_RE_small moved 7 codes of layer3_4 (3.2e-5),
# then up to 0.0055 of a later map's codes, 0.16 of the 1x1 gate's, the
# logits 0.013 of their range and the argmax at 0.0106 of the pixels;
# mobilenetv3_large and image 0 moved none. Bands for such an image:
SEG_FLIP_MAP_SHARE, SEG_FLIP_GATE_SHARE = 0.02, 0.25
SEG_FLIP_LOGIT_BAND, SEG_FLIP_ARGMAX_SHARE = 0.05, 0.03
SEG_TRAINER_CFG = dict(model=SEG_MODELS_CHECKED[0], dataset="synthetic", crop_size=SEG_CROP,
                       batch_size=8, steps_per_epoch=2, fp_epochs=1, epochs=1, seed=0)


def seg_layer_codes(model, fn, images):
    """(output, {layer: codes}) of one ``fn(images)`` call on a frozen
    segmentation model: the QTensor output of ``quant``, of each child of
    ``backbone`` and of ``head/lr_aspp`` and its children, and as
    ``head/lr_aspp/pool`` the pooled codes that ``b1_conv`` takes (the
    JAX module paths, joined by ``/``). The hooks only keep references."""
    codes, hooks = {}, []
    for name, mod in model.named_modules():
        parts = name.split(".")
        in_head = len(parts) == 3 and parts[:2] == ["head", "lr_aspp"]
        if not name or not (len(parts) <= 2 or in_head):
            continue
        key = "/".join(parts)

        def hook(m, args, out, key=key):
            if key == "head/lr_aspp/b1_conv":
                codes["head/lr_aspp/pool"] = args[0].q
            if isinstance(out, QTensor):
                codes[key] = out.q
        hooks.append(mod.register_forward_hook(hook))
    try:
        out = fn(images)
    finally:
        for h in hooks:
            h.remove()
    return out, codes


def seg_variables(name: str) -> dict:
    """The flat variables of a segmentation fixture: ``numpy_init(model, 0)``
    with the committed calibration on top (``tests/test_torch_seg_fixture.py``
    makes it)."""
    from frostnet_tpu_torch.segmentation import get_seg_model

    flat = flatten_variables(numpy_init(get_seg_model(name, num_classes=SEG_CLASSES), 0))
    with np.load(os.path.join(TESTDATA, f"seg_{name}_calibration.npz")) as cal:
        for k in cal.files:
            if k not in flat or flat[k].shape != cal[k].shape:
                raise AssertionError(f"{name} calibration: {k} does not fit the model")
            flat[k] = cal[k]
    return flat


def seg_served_model(name: str, device, artifact_dir=None):
    """The segmentation fixture as a user serves it: the port's model filled
    with :func:`seg_variables`, written by the port's ``export_int8`` (into
    ``artifact_dir`` or a temporary directory), read back with
    ``load_int8`` into a fresh model and frozen on ``device``. Returns
    (model, ``fn(images) -> logits``)."""
    from frostnet_tpu_torch.quant import load_int8
    from frostnet_tpu_torch.segmentation import get_seg_model

    trained = from_jax_variables(get_seg_model(name, num_classes=SEG_CLASSES),
                                 unflatten_variables(seg_variables(name)))
    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(artifact_dir or tmp, f"seg_{name}_int8.npz")
        if artifact_dir:
            os.makedirs(artifact_dir, exist_ok=True)
        export_int8(trained, artifact)
        model = from_jax_variables(get_seg_model(name, num_classes=SEG_CLASSES),
                                   load_int8(artifact))
    return model, freeze(model, device)


def seg_images(seed: int, batch: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(batch, SEG_CROP, SEG_CROP, 3).astype(np.float32)


def se_layers(model):
    """The trunk's blocks with a squeeze-excite, by their layer names."""
    return {f"backbone/{n}" for n, m in model.backbone.named_children()
            if getattr(m, "se_on", False)}


def check_seg_layers(name, codes, ref, with_se):
    """Every layer's digests (in forward order) against the JAX reference.
    The first layer that differs must be a block of ``with_se`` within
    ``MB_FLIP_SHARE`` of its codes (histogram); the later ones within
    ``SEG_FLIP_MAP_SHARE`` (``SEG_FLIP_GATE_SHARE`` for the gate's 1x1 maps).
    Returns (layers, {layer: what moved}, the images with moved codes)."""
    layers = [k for k in codes if f"sha256/{k}" in ref.files]
    missing = {k[len("sha256/"):] for k in ref.files if k.startswith("sha256/")} - set(layers)
    if missing:
        raise AssertionError(f"{name}: no codes recorded at {sorted(missing)}")
    moved, images_moved = {}, set()
    for layer in layers:
        got = codes[layer]
        if tuple(got.shape[1:]) != tuple(ref[f"shape/{layer}"][1:]):
            raise AssertionError(f"{name} {layer}: shape {tuple(got.shape)}")
        digests = code_digests(got)
        images = [i for i, (g, w) in enumerate(zip(digests, ref[f"sha256/{layer}"])) if g != w]
        if not images:
            continue
        lo, want = int(ref[f"histmin/{layer}"]), ref[f"hist/{layer}"]
        vals = got[:len(digests)].reshape(-1).to(torch.int64).cpu() - lo
        hist = torch.bincount(torch.clamp(vals, min=0), minlength=len(want)).numpy()[:len(want)]
        share = float(np.abs(hist - want).sum() / 2 / got.numel())
        origin = not moved
        limit = (MB_FLIP_SHARE if origin else
                 SEG_FLIP_GATE_SHARE if got.shape[1] * got.shape[2] == 1 else SEG_FLIP_MAP_SHARE)
        moved[layer] = {"images": images, "hist_share": share}
        images_moved.update(images)
        if (origin and layer not in with_se) or share > limit:
            raise AssertionError(f"{name}: codes differ from the JAX reference at {layer} "
                                 f"(images {images}, histogram share {share:.3g}; "
                                 f"{'first differing layer' if origin else 'limit'} {limit})")
    return layers, moved, images_moved


def seg_logits_check(name, logits, ref, images_moved=()):
    """Each image's sampled logits within ``SEG_LOGIT_BAND`` of their range
    and its argmax within ``SEG_ARGMAX_SHARE`` of the committed JAX
    reference; an image with moved codes within the flip bands."""
    o = SEG_LOGIT_STRIDE // 2
    got = logits[:, o::SEG_LOGIT_STRIDE, o::SEG_LOGIT_STRIDE].cpu().numpy()
    want = ref["logits_sampled"][:got.shape[0]]
    argmax = logits.argmax(-1).cpu().numpy()
    span = float(want.max() - want.min())
    out = []
    for i in range(got.shape[0]):
        diff = float(np.abs(got[i] - want[i]).max())
        share = float((argmax[i] != ref["argmax"][i]).mean())
        band, arg = ((SEG_FLIP_LOGIT_BAND, SEG_FLIP_ARGMAX_SHARE) if i in images_moved
                     else (SEG_LOGIT_BAND, SEG_ARGMAX_SHARE))
        if not np.isfinite(got[i]).all() or diff > band * span or share > arg:
            raise AssertionError(f"{name} image {i}: logits {diff:.3g} from JAX's (band "
                                 f"{band * span:.3g}), argmax differs at {share:.3g} (band {arg})")
        out.append({"logits_max_diff": diff, "argmax_mismatch_share": share,
                    "codes_moved": i in images_moved})
    return {"logits_span": span, "images": out}


def serve_segs(dev):
    """Phase 17, part a: each segmentation fixture served at 768x768 from
    the port's own export: every layer's codes against the committed JAX
    digests, the logits and the argmax in their bands, one matmul launch per
    1x1 or im2col conv and nothing else."""
    images = seg_images(0, 2)
    out, served = {}, {}
    for name in SEG_MODELS_CHECKED:
        ref = np.load(os.path.join(TESTDATA, f"seg_{name}_reference.npz"))
        model, fn = seg_served_model(name, dev, PHASE17_DIR)
        served[name] = (model, fn)
        n_mm = len(matmul_convs(model))
        ops.reset_launch_counts()
        logits, codes = seg_layer_codes(model, fn, images)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expect = {"int8_matmul_requant": n_mm, "frost_block_int8": 0, "fake_quant_observe": 0,
                  "int8_conv": 0}
        if counts != expect:
            raise AssertionError(f"{name}: launches per forward {counts} != {expect}")
        layers, moved, images_moved = check_seg_layers(name, codes, ref, se_layers(model))
        rec = {"launches": counts, "layers": len(layers), "moved": moved,
               **seg_logits_check(name, logits, ref, images_moved)}
        out[name] = rec
        log(f"[seg] {name} served at {SEG_CROP}x{SEG_CROP}, batch 2: launches per forward "
            f"{counts}; codes == JAX reference at {len(layers) - len(moved)} of {len(layers)} "
            f"layers x 2 images{f' (moved, in the bands: {moved})' if moved else ''}; per image, "
            f"sampled logits from JAX's (span {rec['logits_span']:.4g}) and argmax mismatch: "
            + ", ".join(f"{r['logits_max_diff']:.3g} / {r['argmax_mismatch_share']:.3g}"
                        for r in rec["images"]))
    return out, served


def check_seg_matmuls(served, dev):
    """Phase 17, part b: the matmul kernel against its plain version at every
    INT8 matmul of each model's forward at batch 8 and 16 (its inputs, and
    the same input one byte into its storage). Returns (max error, the
    distinct (model, conv, operand) of the batch-16 forwards)."""
    err, shapes, rows = 0, {}, []
    for b in (8, 16):
        x = torch.as_tensor(seg_images(1, b), device=dev)
        for name, (model, _) in served.items():
            for cname, mod, inp in capture(model, x):
                if getattr(mod, "_route", None) not in ("matmul", "im2col"):
                    continue
                a, op = matmul_operand(mod, inp.q), mod._op
                want = int8_matmul_requant_plain(a, op)
                err = max(err, check_equal(f"int8_matmul_requant {name} {cname} batch {b}",
                                           int8_matmul_requant(a, op), want))
                buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
                shifted = buf[1:].view(a.shape)
                shifted.copy_(a)
                err = max(err, check_equal(f"int8_matmul_requant {name} {cname} batch {b} "
                                           "(unaligned rows)", int8_matmul_requant(shifted, op),
                                           want))
                key = matmul_shape(a, op)
                shapes.setdefault(b, set()).add(key)
                if b == 16 and name == SEG_MODELS_CHECKED[0]:
                    rows.append((f"{name} {cname}", a, op))
                del buf, shifted, want
        del x
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return err, {b: sorted(v) for b, v in shapes.items()}, rows


def check_seg_fake_quant(dev):
    """Phase 17, part c: the fake-quant kernel against its plain version,
    bit for bit, at every per-tensor site of a full-width float32 QAT
    forward of the default model at batch 16 (768x768), with the QAT_FROZEN
    pass. Returns (checks, max error, sites, the sites for timing)."""
    from frostnet_tpu_torch.segmentation import get_seg_model

    model = get_seg_model(SEG_MODELS_CHECKED[0])
    from_jax_variables(model, numpy_init(model, 0)).to(dev)
    n_sites = observers(model)
    sites = capture_sites(model, torch.as_tensor(seg_images(2, 16), device=dev), QAT)
    if len(sites) != n_sites:
        raise AssertionError(f"segmentation: {len(sites)} per-tensor sites in a QAT forward, "
                             f"expected {n_sites}")
    err = 0.0
    for i, (x, mn, mx, spec) in enumerate(sites):
        err = max(err, check_site(f"seg site {i} {tuple(x.shape)}", x, mn, mx, spec))
    torch.cuda.synchronize()
    return len(sites), err, n_sites, sites


def seg_train_batch(k: int, crop: int, batch: int):
    """Batch ``k`` of the segmentation training reference: ``RandomState(300
    + k)`` images (``randn``), then labels (``randint(0, 19)``) with every
    19th pixel set to the ignore label 255."""
    rng = np.random.RandomState(300 + k)
    image = rng.randn(batch, crop, crop, 3).astype(np.float32)
    label = rng.randint(0, SEG_CLASSES, (batch, crop, crop)).astype(np.int32)
    label.reshape(-1)[::19] = 255
    return {"image": image, "label": label}


def train_seg_against_reference(dev):
    """Phase 17, part d: the segmentation train step against the committed
    JAX reference (256x256, batch 2, float32, TF32 off): one FP32 step,
    ``start_qat``, two QAT steps, a QAT_FROZEN eval step, in phase 8's bands;
    the fake-quant launches per step."""
    from frostnet_tpu_torch.segmentation import get_seg_model, train as seg_train
    from frostnet_tpu_torch.segmentation.data import CITYSCAPES_CLASS_WEIGHTS

    ref = np.load(SEG_TRAIN_REFERENCE)
    meta = json.loads(bytes(ref["__meta__"]).decode())
    model = get_seg_model(meta["model"])
    n_sites = observers(model)
    tx = get_optimizer("QSGD", meta["lr"], weight_decay=grouped_weight_decay(meta["wd"]),
                       noise_decay=1.0)
    state = create_train_state(model, tx, seed=meta["seed"], device=dev)
    fq = ops.fake_quant_observe

    def batch(k):
        return seg_train_batch(k, meta["crop"], meta["batch"])

    losses, cms, launches = [], [], []
    for k, mode in enumerate((FP32, QAT, QAT)):
        if k == 1:
            state.start_qat()
        before = fq.launches
        m = seg_train.make_seg_train_step(mode, CITYSCAPES_CLASS_WEIGHTS, 255, SEG_CLASSES)(
            state, batch(k))
        losses.append(float(m["loss"]))
        cms.append(m["cm"].cpu().numpy())
        launches.append(fq.launches - before)
    before = fq.launches
    cms.append(seg_train.make_seg_eval_step(QAT_FROZEN, SEG_CLASSES, 255)(state, batch(3))
               .cpu().numpy())
    launches.append(fq.launches - before)
    torch.cuda.synchronize()
    if launches != [0, n_sites, n_sites, n_sites]:
        raise AssertionError(f"segmentation steps: fake_quant_observe launches {launches} != "
                             f"[0, {n_sites}, {n_sites}, {n_sites}]")
    rep = {"losses": losses, "launches_per_step": launches}
    rel = [abs(a - float(b)) / float(b) for a, b in zip(losses, ref["loss"])]
    rep["loss_rel"] = rel
    band_check("segmentation FP32 step loss, relative to JAX", rel[0], FP32_LOSS_REL)
    band_check("segmentation QAT losses, worst relative to JAX", max(rel[1:]), QAT_LOSS_REL)
    moved = float(np.abs(cms[0] - ref["cm"][0]).sum() / 2 / ref["cm"][0].sum())
    rep["fp32_cm_moved_share"] = moved
    band_check("segmentation FP32 step confusion matrix, share of pixels moved", moved,
               SEG_ARGMAX_SHARE)
    if [int(c.sum()) for c in cms] != [int(c.sum()) for c in ref["cm"]]:
        raise AssertionError("segmentation steps counted other pixels than JAX's")
    mine = {k: v.detach().cpu().numpy() for k, v in model_variables(state.model).items()}
    obs = []
    for k in ref.files:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(ref[hi] - ref[k]), 1e-6)
            obs.append(max(abs(float(mine[k] - ref[k])), abs(float(mine[hi] - ref[hi]))) / span)
    if len(obs) != n_sites:
        raise AssertionError(f"{len(obs)} observers in the reference, {n_sites} in the model")
    rep["observer_rel_range"] = {"median": float(np.median(obs)), "worst": float(max(obs))}
    band_check("segmentation observers, median |diff| / range", float(np.median(obs)), OBS_MEDIAN)
    band_check("segmentation observers, worst |diff| / range", float(max(obs)), OBS_WORST)
    bn_mean = [float(np.max(np.abs(mine[k] - ref[k]) / np.sqrt(ref[k[:-4] + "var"])))
               for k in ref.files if k.endswith("/mean")]
    bn_var = [float(np.max(np.abs(mine[k] - ref[k]) / ref[k])) for k in ref.files
              if k.endswith("/var")]
    rep["bn"] = {"mean_over_std_median": float(np.median(bn_mean)),
                 "var_rel_median": float(np.median(bn_var))}
    band_check("segmentation BN means, median |diff| / std", float(np.median(bn_mean)),
               BN_MEAN_MEDIAN)
    band_check("segmentation BN variances, median |diff| / var", float(np.median(bn_var)),
               BN_VAR_MEDIAN)
    return rep


def seg_trainer_path(dev):
    """Phase 17, part e: ``segmentation.train.main`` at 768x768 (batch 8, 2
    steps an epoch, one FP32 and one QAT epoch), its resume to a second QAT
    epoch, ``evaluate.main --export_int8`` on ``best/``; the artifact served
    in a fresh model gives the evaluator's INT8 mIoU, and ``evaluate.main`` on
    the final ``checkpoint/`` gives the trainer's; each step's launches as
    the model's sites and matmuls say."""
    from frostnet_tpu_torch.quant import load_int8
    from frostnet_tpu_torch.segmentation import evaluate as seg_eval
    from frostnet_tpu_torch.segmentation import get_seg_model, train as seg_train

    root = os.path.join(PHASE17_DIR, "trainer")
    shutil.rmtree(root, ignore_errors=True)
    save_dir = os.path.join(root, "run")
    probe = get_seg_model(SEG_TRAINER_CFG["model"])
    n_sites = observers(probe)
    probe.prepare_int8("cpu")
    n_mm = len(matmul_convs(probe))
    zero = {"fake_quant_observe": 0, "int8_matmul_requant": 0, "int8_conv": 0}
    expect = {("train", FP32): zero,
              ("train", QAT): {**zero, "fake_quant_observe": n_sites},
              ("eval", QAT_FROZEN): {**zero, "fake_quant_observe": n_sites},
              ("eval", INT8): {**zero, "int8_matmul_requant": n_mm}}
    names = ("make_seg_train_step", "make_seg_eval_step")
    rep = {}
    torch.cuda.reset_peak_memory_stats()
    with StepCounter(seg_train, *names) as counter:
        _, res = seg_train.main(seg_train.SegConfig(save_dir=save_dir, device=dev.type,
                                                    **SEG_TRAINER_CFG))
    rep["train_steps"] = check_step_launches(counter.rows, "segmentation train run", expect)
    for f in ("checkpoint", "best", "checkpoint_meta.json", "metrics.jsonl", "arguments.json"):
        if not os.path.exists(os.path.join(save_dir, f)):
            raise AssertionError(f"segmentation trainer: {f} was not written")
    with StepCounter(seg_train, *names) as counter:
        _, resumed = seg_train.main(seg_train.SegConfig(
            save_dir=save_dir, resume=True, device=dev.type, **{**SEG_TRAINER_CFG, "epochs": 2}))
    rep["resume_steps"] = check_step_launches(counter.rows, "segmentation resume", expect)
    if resumed["resumed"] != {"qat_epoch": 1, "step": 4} or \
            [h["tag"] for h in resumed["history"]] != ["qat"]:
        raise AssertionError(f"segmentation resume: {resumed['resumed']}, "
                             f"{[h['tag'] for h in resumed['history']]}")
    history = res["history"] + resumed["history"]
    for h in history:
        if not np.isfinite(h["loss"]):
            raise AssertionError(f"segmentation trainer: {h['tag']} loss {h['loss']}")
    rep["epochs"] = [{"tag": h["tag"], "epoch": h["epoch"], "loss": h["loss"],
                      "images_per_sec": h["images_per_sec"], "step_ms": h["step_ms"],
                      "val_miou": h.get("val", {}).get("miou")} for h in history]
    rep["final"] = {k: resumed[k]["miou"] for k in ("qat", "int8")}
    for e in rep["epochs"]:
        log(f"[seg] trainer {e['tag']} epoch {e['epoch']}: loss {e['loss']:.4f}, "
            f"{e['images_per_sec']:.1f} images/s, step wall ms "
            f"{[round(t, 1) for t in e['step_ms']]}, val mIoU {e['val_miou']}")
    artifact = os.path.join(root, "seg_int8.npz")
    common = ["--model", SEG_TRAINER_CFG["model"], "--crop_size",
              str(SEG_TRAINER_CFG["crop_size"]), "--batch_size",
              str(SEG_TRAINER_CFG["batch_size"]), "--device", dev.type]
    with StepCounter(seg_train, *names) as counter:
        ev = seg_eval.main(seg_eval.build_parser().parse_args(
            common + ["--checkpoint", os.path.join(save_dir, "best"), "--export_int8",
                      artifact]))
        last = seg_eval.main(seg_eval.build_parser().parse_args(
            common + ["--checkpoint", os.path.join(save_dir, "checkpoint")]))
    rep["evaluate_steps"] = check_step_launches(counter.rows, "segmentation evaluate", expect)
    state = create_train_state(get_seg_model(SEG_TRAINER_CFG["model"]),
                               get_optimizer("QSGD", 1e-3), device=dev,
                               variables=load_int8(artifact))
    cfg = seg_train.resolve_dataset_defaults(seg_train.SegConfig(
        crop_size=SEG_TRAINER_CFG["crop_size"], batch_size=SEG_TRAINER_CFG["batch_size"]))
    served = seg_train.evaluate_seg(state, seg_eval.eval_dataset(cfg, ""), dev, INT8, cfg)
    if served["miou"] != ev["int8"] or not np.array_equal(served["cm"], ev["int8_eval"]["cm"]):
        raise AssertionError(f"served artifact mIoU {served['miou']} != the evaluator's "
                             f"{ev['int8']}")
    if last["int8"] != resumed["int8"]["miou"] or \
            not np.array_equal(last["int8_eval"]["cm"], resumed["int8"]["cm"]):
        raise AssertionError(f"evaluate.main on the final checkpoint: INT8 mIoU {last['int8']} "
                             f"!= the trainer's {resumed['int8']['miou']}")
    rep["evaluate"] = {"best": {"qat": ev["qat"], "int8": ev["int8"],
                                "export_bytes": ev["export_bytes"]},
                       "final": {"qat": last["qat"], "int8": last["int8"]},
                       "served_artifact_int8": served["miou"]}
    rep["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[seg] trainer path: steps {rep['train_steps']}, resume {rep['resume_steps']}, "
        f"evaluate {rep['evaluate_steps']} (fake_quant_observe {n_sites} per QAT step and "
        f"QAT_FROZEN forward, int8_matmul_requant {n_mm} per INT8 forward); final mIoU QAT sim "
        f"{rep['final']['qat']:.4f}, INT8 {rep['final']['int8']:.4f} (== evaluate.main on "
        f"checkpoint/); evaluate.main on best/: {rep['evaluate']['best']}; its artifact served "
        f"in a fresh model gives the same INT8 mIoU and confusion matrix; peak memory "
        f"{rep['peak_memory_gib']:.2f} GiB")
    return rep


def time_seg_steps(dev, batch=16):
    """Phase 17, part f: the float32 QAT and FP32 train steps of the default
    model at 768x768: ms/step, images/s, peak memory, launches a step."""
    from frostnet_tpu_torch.segmentation import get_seg_model, train as seg_train
    from frostnet_tpu_torch.segmentation.data import CITYSCAPES_CLASS_WEIGHTS

    model = get_seg_model(SEG_MODELS_CHECKED[0])
    tx = get_optimizer("QSGD", 0.05, weight_decay=grouped_weight_decay(4e-5))
    state = create_train_state(model, tx, seed=0, device=dev)
    rng = np.random.RandomState(4)
    b = {"image": torch.as_tensor(seg_images(4, batch), device=dev),
         "label": torch.as_tensor(rng.randint(0, SEG_CLASSES, (batch, SEG_CROP, SEG_CROP))
                                  .astype(np.int32), device=dev)}
    rec = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mode, tag in ((FP32, "fp32"), (QAT, "qat")):
        if mode is QAT:
            state.start_qat()
        step = seg_train.make_seg_train_step(mode, CITYSCAPES_CLASS_WEIGHTS, 255, SEG_CLASSES)
        before = ops.launch_counts()
        step(state, b)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        rec[f"{tag}_launches"] = {k: after[k] - before[k] for k in after}
        ms = time_ms(lambda: step(state, b), reps=3, warmup=1)
        rec[f"{tag}_ms_per_step"], rec[f"{tag}_images_per_sec"] = ms, batch / ms * 1e3
    rec["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[time] segmentation train steps at {SEG_CROP}x{SEG_CROP}, batch {batch} (float32): "
        f"QAT {rec['qat_ms_per_step']:.2f} ms/step, {rec['qat_images_per_sec']:.2f} images/s; "
        f"FP32 {rec['fp32_ms_per_step']:.2f} ms/step, {rec['fp32_images_per_sec']:.2f} images/s; "
        f"peak memory {rec['max_memory_allocated_gib']:.2f} GiB; launches QAT "
        f"{rec['qat_launches']}, FP32 {rec['fp32_launches']}")
    del state, model, b
    torch.cuda.empty_cache()
    return rec


def time_segs(served, mm_rows, sites, dev):
    """Phase 17, part f: the INT8 forward at batch 1, 8 and 16; one profiled
    forward at batch 8 (the matmul kernel, the torch ops, the idle share)
    and the device time of the torch-op groups (dilated depthwise convs,
    hard-swishes, squeeze-excites); the matmul kernel at each distinct
    matmul of the batch-16 forward and the fake-quant kernel at the sites
    of part c, each beside its bound, its plain version and the library
    call."""
    out = {"serving": {}}
    for name, (model, fn) in served.items():
        rec = {}
        for b in (1, 8, 16):
            xb = torch.as_tensor(seg_images(5, b), device=dev)
            ms = time_ms(lambda: fn(xb), reps=10 if b < 16 else 5, warmup=1)
            rec[f"bs{b}"] = {"ms_per_batch": ms, "images_per_sec": b / ms * 1e3}
            log(f"[time] {name} INT8 forward at {SEG_CROP}x{SEG_CROP}, batch {b}: {ms:.3f} "
                f"ms/batch, {b / ms * 1e3:.2f} images/s")
            del xb
        x8 = torch.as_tensor(seg_images(6, 8), device=dev)
        try:
            rec["profile"] = profile_forward(fn, x8, MB_KERNELS)
            log_profile(f"{name} INT8 forward at batch 8", rec["profile"])
        except RuntimeError as e:  # torch.profiler stops recording after many sessions
            log(f"[time] {name}: no profile ({e})")
            rec["profile"] = None
        groups = {}
        with torch.inference_mode():
            for group, calls in group_inputs(model, x8).items():
                if not calls:
                    continue

                def run(calls=calls):
                    return [m(x, INT8) for m, x in calls]

                groups[group] = {"modules": len(calls), "device_ms": graph_ms(run, 3),
                                 "wall_ms": time_ms(run, reps=3)}
        rec["groups"] = groups
        log(f"[time] {name} torch-op groups at batch 8, ms device (CUDA graph) / wall: "
            + ", ".join(f"{g} {v['device_ms']:.4f} / {v['wall_ms']:.4f} ({v['modules']} modules)"
                        for g, v in groups.items()))
        out["serving"][name] = rec
        del x8
    rows, seen = [], set()
    for label, a, op in mm_rows:
        key = (a.shape[0], op.k, op.n)
        if key in seen:
            continue
        seen.add(key)
        rows.append(kernel_row(f"{label} {matmul_shape(a, op)}", lambda: int8_matmul_requant(a, op),
                               lambda: int8_matmul_requant_plain(a, op),
                               matmul_cost(a.shape[0], op.k, op.n), int_mm_ms(a, op.wt, reps=10),
                               reps=10, plain_reps=1))
        rows[-1]["path"] = "seg"
        log(f"[time] int8_matmul_requant {rows[-1]['shape']}: {row_text(rows[-1])}")
    out["fake_quant"] = fq = time_fake_quant_sites(sites)
    lib = "n/a" if fq["library_ms"] is None else (
        f"{fq['library_ms']:.4f} device, {fq['library_wall_ms']:.4f} wall")
    log(f"[time] fake_quant_observe, the {len(sites)} sites of a segmentation QAT forward at "
        f"batch 16 ({SEG_CROP}x{SEG_CROP}, float32): {fq['ms']:.4f} ms device, "
        f"{fq['graph_ms']:.4f} graph, {fq['wall_ms']:.4f} wall ({fq['launches_per_site']} launch "
        f"a site; bound {fq['bound_ms']:.4f} {fq['bound_by']}, {100 * fq['bound_share']:.1f}%; "
        f"plain {fq['plain_ms']:.3f}, fused_moving_avg_obs_fake_quant {lib})")
    for line in bucket_lines(fq):
        log(f"    {line}")
    return rows, out


def seg_phase(dev):
    """Phase 17: segmentation on the card (serving against the JAX digests,
    the matmul and fake-quant kernels at the segmentation shapes, training
    against the JAX reference, the trainer and evaluator, times). Returns
    (report, launches of each path, matmul timing rows)."""
    rep, launches = {}, {}
    os.makedirs(PHASE17_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep["serving"], served = serve_segs(dev)
    launches["serving"] = {n: r["launches"] for n, r in rep["serving"].items()}
    rep["matmul_max_abs_err"], rep["matmul_shapes"], mm_rows = check_seg_matmuls(served, dev)
    log(f"[seg] int8_matmul_requant == plain at every matmul of both forwards at batch 8 and "
        f"16, aligned and unaligned rows: {rep['matmul_shapes']}")
    checked, rep["fake_quant_max_abs_err"], n_sites, sites = check_seg_fake_quant(dev)
    rep["fake_quant_site_checks"] = checked
    log(f"[seg] fake_quant_observe == plain at all {checked} sites of a {SEG_MODELS_CHECKED[0]} "
        f"QAT forward at batch 16 (float32; QAT and QAT_FROZEN passes); largest "
        f"{max(tuple(x.shape) for x, _, _, _ in sites)} "
        f"({max(x.numel() for x, _, _, _ in sites) / 1e6:.1f} M elements)")
    ops.reset_launch_counts()
    rep["training_reference"] = train_seg_against_reference(dev)
    launches["training"] = ops.launch_counts()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    rep["trainer"] = seg_trainer_path(dev)
    launches["trainer"] = ops.launch_counts()
    for k in ("fake_quant_observe", "int8_matmul_requant"):
        if launches["trainer"][k] == 0:
            raise AssertionError(f"phase 17's trainer path launched no {k}")
    torch.cuda.empty_cache()
    rep["train_steps"] = time_seg_steps(dev)
    mm, rep["timing"] = time_segs(served, mm_rows, sites, dev)
    del served, sites, mm_rows
    torch.cuda.empty_cache()
    return rep, launches, mm


# ---------------------------------------------------------------------------
# Phase 18: object detection (SSDLite-MobileNetV2 and Tiny-DSOD at 300x300)
# ---------------------------------------------------------------------------
DET_NETS = ("qssd", "qtdsod")
DET_SIZE, DET_CLASSES = 300, 21
PHASE18_DIR = os.path.join(ROOT, "build", "phase18")
DET_TRAIN_REFERENCE = os.path.join(TESTDATA, "det_qssd_train_reference.npz")
# The fixtures store loc and conf at every DET_PRIOR_STRIDE-th prior. The
# head is float32 (TF32 off) on bit-equal sources, but its 3x3 convs sum in
# other orders than XLA's: loc and conf within DET_HEAD_BAND of their range,
# absolute. detect()'s kept boxes at the server's settings (DET_SERVE) then
# agree: per image and class as many, each score and coordinate within
# DET_BOX_BAND. The same bands hold on the CPU (tests/test_torch_det_fixture.py).
DET_PRIOR_STRIDE, DET_HEAD_BAND, DET_BOX_BAND = 4, 1e-5, 1e-5
DET_SERVE = dict(conf_thresh=0.25, top_k=50)
# The training check's QAT_FROZEN eval of the loss after two QAT steps: the
# observers agree (median 8e-5 of their range, worst 0.2%), but each frozen
# grid that moves by so little re-rounds a whole map, and the eval's loss
# follows: the port against JAX 1.2-4.6% apart on 1-8 CPU threads and 6.2%
# on the card (NVIDIA H100 80GB HBM3, 700 W), the port against itself 3.4%
# apart between 1 and 8 CPU threads. The FP32 and QAT steps keep phase 8's
# bands (measured 7e-8, 0.45% and 0.73% on the card).
DET_EVAL_LOSS_REL = 0.15


def det_variables(net: str):
    """(feat_vars, head_vars) of a detection fixture: ``numpy_init((feat,
    head), 0)`` with the committed calibration on top
    (``tests/test_torch_det_fixture.py`` makes it; flat keys of the
    ``Detector`` tree, ``params/feat/...``)."""
    from frostnet_tpu_torch.detection.models import join_variables, split_variables
    from frostnet_tpu_torch.detection.train import build_net

    flat = flatten_variables(join_variables(*numpy_init(build_net(net, DET_CLASSES), 0)))
    with np.load(os.path.join(TESTDATA, f"det_{net}_calibration.npz")) as cal:
        for k in cal.files:
            if k not in flat or flat[k].shape != cal[k].shape:
                raise AssertionError(f"{net} calibration: {k} does not fit the model")
            flat[k] = cal[k]
    return split_variables(unflatten_variables(flat))


def det_train_variables(net: str = "qssd"):
    """The start of the detection training reference: :func:`det_variables`
    with the head's conf BN scales back at 1 (the fixture's gain of 3 makes
    the conf losses large, and the QAT_FROZEN eval loss after two QAT steps
    then moved by up to 9% between the port on 1 and 8 CPU threads; at 1 it
    moved 3.4%)."""
    fv, hv = det_variables(net)
    flat = flatten_variables(hv)
    for k in flat:
        parts = k.split("/")
        if parts[0] == "params" and parts[-1] == "scale" and parts[-2].startswith("conf"):
            flat[k] = np.ones_like(flat[k])
    return fv, unflatten_variables(flat)


def det_served(net: str, device, artifact_dir=None):
    """The detection fixture as a user serves it: the port's nets filled with
    :func:`det_variables`, written by the port's ``export_int8`` as
    ``det_<net>_feat.npz`` and ``det_<net>_head.npz`` (into ``artifact_dir``
    or a temporary directory) and served by ``serve.DetPredictor``."""
    from frostnet_tpu_torch.detection.train import build_net

    feat, head = from_jax_variables(build_net(net, DET_CLASSES), det_variables(net))
    if artifact_dir:
        os.makedirs(artifact_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(artifact_dir or tmp, f"det_{net}")
        export_int8(feat, base + "_feat")
        export_int8(head, base + "_head")
        return serve.DetPredictor(net, artifact=base, device=device)


def det_train_batch(k: int, batch: int = 2):
    """Batch ``k`` of the detection training reference: the first batch of
    ``SyntheticDetection(20, 300, batch, batch, seed=400 + k)`` (normal
    images, 1-5 boxes an image padded to ``MAX_GT``)."""
    from frostnet_tpu_torch.detection.data import SyntheticDetection

    return next(iter(SyntheticDetection(DET_CLASSES - 1, DET_SIZE, batch, batch, 400 + k)))


def det_images(seed: int, batch: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(batch, DET_SIZE, DET_SIZE, 3).astype(np.float32)


def det_layer_codes(pred, images):
    """((loc, conf), sources, {layer: codes}) of one ``pred(images)`` call:
    the QTensor output of every top-level module of the feature net (the JAX
    module paths) and the feature net's dequantized sources. The hooks only
    keep references."""
    codes, got, hooks = {}, {}, []
    for name, mod in pred.feat.named_children():
        def hook(m, args, out, name=name):
            if isinstance(out, QTensor):
                codes[name] = out.q
        hooks.append(mod.register_forward_hook(hook))
    hooks.append(pred.feat.register_forward_hook(
        lambda m, args, out: got.__setitem__("sources", out)))
    try:
        out = pred(images)
    finally:
        for h in hooks:
            h.remove()
    return out, got["sources"], codes


def check_det_layers(net: str, codes, sources, ref):
    """Every layer's codes and every source's float32 values against the JAX
    reference's per-image digests; returns the layers checked."""
    layers = [k[len("sha256/"):] for k in ref.files if k.startswith("sha256/")]
    got = dict(codes, **{f"source{i}": s for i, s in enumerate(sources)})
    bad = []
    for layer in layers:
        t = got.get(layer)
        if t is None or tuple(t.shape[1:]) != tuple(ref[f"shape/{layer}"][1:]):
            bad.append(f"{layer} (shape {None if t is None else tuple(t.shape)})")
            continue
        images = [i for i, (g, w) in enumerate(zip(code_digests(t), ref[f"sha256/{layer}"]))
                  if g != w]
        if images:
            bad.append(f"{layer} (images {images})")
    missing = sorted(set(codes) - set(layers))
    if bad or missing:
        raise AssertionError(f"{net}: differs from the JAX reference at {bad}; layers without "
                             f"a reference {missing}")
    return layers


def kept_boxes(dets: np.ndarray):
    """{(image, class): (n, 5) rows with a score, sorted by (x1, y1)}."""
    out = {}
    for b in range(dets.shape[0]):
        for c in range(1, dets.shape[1]):
            rows = dets[b, c][dets[b, c, :, 0] > 0]
            if len(rows):
                out[(b, c)] = rows[np.lexsort((rows[:, 2], rows[:, 1]))]
    return out


def det_outputs_check(net: str, loc, conf, priors, ref):
    """loc and conf (sampled) within ``DET_HEAD_BAND`` of the committed JAX
    head's, and ``detect``'s kept boxes at the server's settings matching
    JAX's within ``DET_BOX_BAND``. Returns the measured differences."""
    from frostnet_tpu_torch.detection.nms import detect

    n = loc.shape[0]
    rep = {}
    for key, t in (("loc", loc), ("conf", conf)):
        got = t[:, ::DET_PRIOR_STRIDE].cpu().numpy()
        want = ref[f"{key}_sampled"][:n]
        span = float(want.max() - want.min())
        diff = float(np.abs(got - want).max())
        rep[key] = {"max_diff": diff, "span": span}
        if not np.isfinite(got).all() or diff > DET_HEAD_BAND * span:
            raise AssertionError(f"{net} {key}: {diff:.3g} from JAX's (band "
                                 f"{DET_HEAD_BAND * span:.3g})")
    dets = detect(loc, torch.softmax(conf, dim=-1), priors, **DET_SERVE).cpu().numpy()
    mine, want = kept_boxes(dets), kept_boxes(ref["detections"][:n])
    if set(mine) != set(want) or any(len(mine[k]) != len(want[k]) for k in want):
        raise AssertionError(f"{net}: detect() keeps {sum(map(len, mine.values()))} boxes in "
                             f"{len(mine)} (image, class) pairs, JAX "
                             f"{sum(map(len, want.values()))} in {len(want)}")
    diff = max((float(np.abs(mine[k] - want[k]).max()) for k in want), default=0.0)
    if diff > DET_BOX_BAND:
        raise AssertionError(f"{net}: kept boxes {diff:.3g} from JAX's (band {DET_BOX_BAND})")
    rep["detections"] = {"kept": sum(map(len, want.values())), "pairs": len(want),
                         "max_diff": diff}
    return rep


def det_band_report(ref, state, losses, what):
    """The training check's bands against the committed JAX reference (phase
    8's): the FP32 step's loss, the two QAT steps' losses, every observer and
    every BN statistic after the last step; the eval's loss in
    ``DET_EVAL_LOSS_REL``. Returns the measured values."""
    rep = {}
    rel = [abs(a - float(b)) / float(b) for a, b in zip(losses, ref["loss"])]
    rep["loss_rel"] = rel
    log(f"[train] {what} losses {losses}, JAX {ref['loss'].tolist()}: relative "
        f"{[f'{r:.3g}' for r in rel]}")
    band_check(f"{what} FP32 step loss, relative to JAX", rel[0], FP32_LOSS_REL)
    band_check(f"{what} QAT step losses, worst relative to JAX", max(rel[1:3]), QAT_LOSS_REL)
    band_check(f"{what} QAT_FROZEN eval loss, relative to JAX", rel[3], DET_EVAL_LOSS_REL)
    mine = {k: v.detach().cpu().numpy() for k, v in model_variables(state.model).items()}
    obs = []
    for k in ref.files:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(ref[hi] - ref[k]), 1e-6)
            obs.append(max(abs(float(mine[k] - ref[k])), abs(float(mine[hi] - ref[hi]))) / span)
    rep["observer_rel_range"] = {"median": float(np.median(obs)), "worst": float(max(obs)),
                                 "count": len(obs)}
    band_check(f"{what} observers, median |diff| / range", float(np.median(obs)), OBS_MEDIAN)
    band_check(f"{what} observers, worst |diff| / range", float(max(obs)), OBS_WORST)
    bn_mean = [float(np.max(np.abs(mine[k] - ref[k]) / np.sqrt(ref[k[:-4] + "var"])))
               for k in ref.files if k.endswith("/mean")]
    bn_var = [float(np.max(np.abs(mine[k] - ref[k]) / ref[k])) for k in ref.files
              if k.endswith("/var")]
    rep["bn"] = {"mean_over_std_median": float(np.median(bn_mean)),
                 "var_rel_median": float(np.median(bn_var))}
    band_check(f"{what} BN means, median |diff| / std", float(np.median(bn_mean)),
               BN_MEAN_MEDIAN)
    band_check(f"{what} BN variances, median |diff| / var", float(np.median(bn_var)),
               BN_VAR_MEDIAN)
    return rep


def train_det_against_reference(dev):
    """Phase 18, part c (and ``tests/test_torch_det_train.py`` on the CPU):
    the detection train step against the committed JAX reference (qssd from
    the calibrated fixture, 300x300, batch 2, float32, TF32 off, QSGD with
    the noise off): one FP32
    step, ``start_qat``, two QAT steps, a QAT_FROZEN eval of the loss, in
    phase 8's bands; on the card, the fake-quant launches of each step (one
    a site in QAT and QAT_FROZEN, none in FP32)."""
    from frostnet_tpu_torch.detection import train as det_train
    from frostnet_tpu_torch.detection.anchors import make_priors
    from frostnet_tpu_torch.detection.models import Detector, join_variables
    from frostnet_tpu_torch.optim import schedules

    ref = np.load(DET_TRAIN_REFERENCE)
    meta = json.loads(bytes(ref["__meta__"]).decode())
    det_cfg = det_train.select_config(meta["net"], "synthetic")
    model = Detector(*det_train.build_net(meta["net"], meta["classes"]))
    n_sites = observers(model)
    tx = get_optimizer("QSGD", schedules.multistep(meta["lr"], det_cfg["lr_steps"], 0.1),
                       momentum=meta["momentum"], weight_decay=meta["wd"],
                       clip_by=meta["clip_by"], noise_decay=1.0)
    state = create_train_state(model, tx, seed=meta["seed"], device=dev,
                               variables=join_variables(*det_train_variables(meta["net"])))
    priors = torch.as_tensor(make_priors(det_cfg), device=dev)
    fq = ops.fake_quant_observe
    losses, parts, launches = [], [], []
    for k, mode in enumerate((FP32, QAT, QAT)):
        if k == 1:
            state.start_qat()
        before = fq.launches
        m = det_train.make_det_train_step(mode, priors)(state, det_train_batch(k, meta["batch"]))
        losses.append(float(m["loss"]))
        parts.append((float(m["loss_l"]), float(m["loss_c"])))
        launches.append(fq.launches - before)
    before = fq.launches
    m = det_train.make_det_eval_step(QAT_FROZEN, priors)(state, det_train_batch(3, meta["batch"]))
    losses.append(float(m["loss"]))
    parts.append((float(m["loss_l"]), float(m["loss_c"])))
    launches.append(fq.launches - before)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        if launches != [0, n_sites, n_sites, n_sites]:
            raise AssertionError(f"detection steps: fake_quant_observe launches {launches} != "
                                 f"[0, {n_sites}, {n_sites}, {n_sites}]")
    rep = {"losses": losses, "loss_l_c": parts, "launches_per_step": launches,
           "sites": n_sites}
    rep.update(det_band_report(ref, state, losses, "detection"))
    return rep


DET_TRAINER_CFG = dict(net_type="qssd", dataset="synthetic", batch_size=32, warmup_iters=2,
                       max_iter=4, seed=0)


def serve_dets(dev):
    """Phase 18, part a: both nets served at 300x300, batch 2, from the
    port's own export through ``serve.DetPredictor``: every layer's codes and
    each source against the committed JAX digests, loc and conf in the band,
    the kept boxes of ``detect`` at the server's settings, one matmul launch
    per 1x1 or im2col conv and nothing else."""
    images = det_images(0, 2)
    out, served = {}, {}
    for net in DET_NETS:
        ref = np.load(os.path.join(TESTDATA, f"det_{net}_reference.npz"))
        pred = det_served(net, dev, PHASE18_DIR)
        served[net] = pred
        n_mm = len(matmul_convs(pred.feat))
        ops.reset_launch_counts()
        (loc, conf), sources, codes = det_layer_codes(pred, images)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expect = {"int8_matmul_requant": n_mm, "frost_block_int8": 0, "fake_quant_observe": 0,
                  "int8_conv": 0}
        if counts != expect:
            raise AssertionError(f"{net}: launches per forward {counts} != {expect}")
        layers = check_det_layers(net, codes, sources, ref)
        rec = {"launches": counts, "layers": len(layers),
               **det_outputs_check(net, loc, conf, pred.priors, ref)}
        out[net] = rec
        log(f"[det] {net} served at {DET_SIZE}x{DET_SIZE}, batch 2: launches per forward "
            f"{counts}; codes and sources == JAX reference at {len(layers)} layers x 2 images; "
            f"loc {rec['loc']['max_diff']:.3g} and conf {rec['conf']['max_diff']:.3g} from JAX's "
            f"(spans {rec['loc']['span']:.4g}, {rec['conf']['span']:.4g}); detect keeps "
            f"{rec['detections']['kept']} boxes in {rec['detections']['pairs']} (image, class) "
            f"pairs as JAX does, within {rec['detections']['max_diff']:.3g}")
    return out, served


def check_det_matmuls(served, dev):
    """Phase 18, part b: the matmul kernel against its plain version at every
    INT8 matmul of both forwards at batch 8 and 32 (the forward's inputs, and
    the same input one byte into its storage). Returns (max error, the
    shapes by batch, the distinct (net, conv, operand) of the batch-8
    forwards)."""
    err, shapes, rows, seen = 0, {}, [], set()
    for b in (8, 32):
        x = torch.as_tensor(det_images(1, b), device=dev)
        for net, pred in served.items():
            for cname, mod, inp in capture(pred.feat, x):
                if getattr(mod, "_route", None) not in ("matmul", "im2col"):
                    continue
                a, op = matmul_operand(mod, inp.q), mod._op
                want = int8_matmul_requant_plain(a, op)
                err = max(err, check_equal(f"int8_matmul_requant {net} {cname} batch {b}",
                                           int8_matmul_requant(a, op), want))
                buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
                shifted = buf[1:].view(a.shape)
                shifted.copy_(a)
                err = max(err, check_equal(f"int8_matmul_requant {net} {cname} batch {b} "
                                           "(unaligned rows)", int8_matmul_requant(shifted, op),
                                           want))
                key = matmul_shape(a, op)
                shapes.setdefault(b, set()).add(key)
                if b == 8 and (a.shape[0], op.k, op.n) not in seen:
                    seen.add((a.shape[0], op.k, op.n))
                    rows.append((f"{net} {cname}", a, op))
                del buf, shifted, want
        del x
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return err, {b: sorted(v) for b, v in shapes.items()}, rows


def check_det_fake_quant(dev, batch=32):
    """Phase 18, part b: the fake-quant kernel against its plain version, bit
    for bit, at every per-tensor site of a float32 QAT forward of qssd at
    batch 32 (300x300), with the QAT_FROZEN pass. Returns (max error, sites)."""
    from frostnet_tpu_torch.detection.models import Detector
    from frostnet_tpu_torch.detection.train import build_net

    model = Detector(*build_net("qssd", DET_CLASSES))
    from_jax_variables(model, numpy_init(model, 0)).to(dev)
    n_sites = observers(model)
    sites = capture_sites(model, torch.as_tensor(det_images(2, batch), device=dev), QAT)
    if len(sites) != n_sites:
        raise AssertionError(f"qssd: {len(sites)} per-tensor sites in a QAT forward, expected "
                             f"{n_sites}")
    err = 0.0
    for i, (x, mn, mx, spec) in enumerate(sites):
        err = max(err, check_site(f"det site {i} {tuple(x.shape)}", x, mn, mx, spec))
    torch.cuda.synchronize()
    return err, sites


def time_det_steps(dev, batch=32):
    """Phase 18, part d: qssd's float32 FP32 and QAT train steps at 300x300
    (the JAX trainer's dtype and batch): ms/step, images/s, peak memory,
    launches a step (the QAT step must launch the fake-quant kernel)."""
    from frostnet_tpu_torch.detection import train as det_train
    from frostnet_tpu_torch.detection.anchors import make_priors
    from frostnet_tpu_torch.detection.models import Detector
    from frostnet_tpu_torch.optim import schedules

    det_cfg = det_train.select_config("qssd", "synthetic")
    model = Detector(*det_train.build_net("qssd", DET_CLASSES))
    tx = get_optimizer("QSGD", schedules.multistep(1e-3, det_cfg["lr_steps"], 0.1),
                       momentum=0.9, weight_decay=5e-4, clip_by=1e-3)
    state = create_train_state(model, tx, seed=0, device=dev)
    priors = torch.as_tensor(make_priors(det_cfg), device=dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in det_train_batch(5, batch).items()}
    rec = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mode, tag in ((FP32, "fp32"), (QAT, "qat")):
        if mode is QAT:
            state.start_qat()
        step = det_train.make_det_train_step(mode, priors)
        before = ops.launch_counts()
        step(state, b)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        rec[f"{tag}_launches"] = {k: after[k] - before[k] for k in after}
        ms = time_ms(lambda: step(state, b), reps=5, warmup=1)
        rec[f"{tag}_ms_per_step"], rec[f"{tag}_images_per_sec"] = ms, batch / ms * 1e3
    if rec["qat_launches"]["fake_quant_observe"] != observers(model) or \
            rec["fp32_launches"]["fake_quant_observe"] != 0:
        raise AssertionError(f"detection train steps: launches QAT {rec['qat_launches']}, FP32 "
                             f"{rec['fp32_launches']}")
    rec["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[time] qssd train steps at {DET_SIZE}x{DET_SIZE}, batch {batch} (float32): QAT "
        f"{rec['qat_ms_per_step']:.2f} ms/step, {rec['qat_images_per_sec']:.2f} images/s; FP32 "
        f"{rec['fp32_ms_per_step']:.2f} ms/step, {rec['fp32_images_per_sec']:.2f} images/s; peak "
        f"memory {rec['max_memory_allocated_gib']:.2f} GiB; launches QAT {rec['qat_launches']}, "
        f"FP32 {rec['fp32_launches']}")
    del state, model, b
    torch.cuda.empty_cache()
    return rec


def det_trainer_path(dev):
    """Phase 18, part e: ``detection.train.main`` (qssd, synthetic, batch 32,
    2 FP32 warm-up and 2 QAT iterations), its resume to a fifth,
    ``qeval.evaluator`` on ``ssd300_5`` with ``--export_int8``; the artifact
    served in a fresh ``DetPredictor`` gives the evaluator's INT8 mAP (and so
    does the calibrated fixture's, whose mAP is not 0); then ``serve.main
    --workload det`` on the trained artifact. Each step's launches."""
    from frostnet_tpu_torch.detection import qeval, train as det_train
    from frostnet_tpu_torch.detection.evaluate import evaluate_map

    root = os.path.join(PHASE18_DIR, "trainer")
    shutil.rmtree(root, ignore_errors=True)
    save_dir = os.path.join(root, "run")
    probe = det_train.build_net("qssd", DET_CLASSES)[0]
    n_sites = observers(probe)
    zero = {"fake_quant_observe": 0, "int8_matmul_requant": 0, "int8_conv": 0}
    expect = {("train", FP32): zero, ("train", QAT): {**zero, "fake_quant_observe": n_sites}}
    names = ("make_det_train_step", "make_det_eval_step")
    rep = {}
    torch.cuda.reset_peak_memory_stats()
    with StepCounter(det_train, *names) as counter:
        _, res = det_train.main(det_train.DetConfig(save_dir=save_dir, device=dev.type,
                                                    **DET_TRAINER_CFG))
    rep["train_steps"] = check_step_launches(counter.rows, "detection train run", expect)
    with StepCounter(det_train, *names) as counter:
        _, resumed = det_train.main(det_train.DetConfig(
            save_dir=save_dir, device=dev.type, resume_iter=4, **{**DET_TRAINER_CFG,
                                                                   "max_iter": 5}))
    rep["resume_steps"] = check_step_launches(counter.rows, "detection resume", expect)
    for f in ("ssd300_4", "ssd300_5", "metrics.jsonl", "arguments.json"):
        if not os.path.exists(os.path.join(save_dir, f)):
            raise AssertionError(f"detection trainer: {f} was not written")
    history = res["history"] + resumed["history"]
    if resumed["resumed"] != 4 or [h["iter"] for h in history] != [1, 2, 3, 4, 5] or \
            not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"detection trainer: {[(h['tag'], h['iter'], h['loss']) for h in history]}")
    rep["iterations"] = [{k: h[k] for k in ("tag", "iter", "loss", "loss_l", "loss_c", "wall_ms")}
                         for h in history]
    for h in rep["iterations"]:
        log(f"[det] trainer {h['tag']} iteration {h['iter']}: loss {h['loss']:.4f} (loc "
            f"{h['loss_l']:.4f}, conf {h['loss_c']:.4f}), {h['wall_ms']:.1f} ms wall")
    base = os.path.join(root, "ssd")
    before = ops.launch_counts()
    ev = qeval.evaluator("qssd", checkpoint=os.path.join(save_dir, "ssd300_5"),
                         export_int8_path=base, batch_size=8, device=dev)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    rep["evaluator_launches"] = {k: after[k] - before[k] for k in after}
    if rep["evaluator_launches"]["fake_quant_observe"] == 0 or \
            rep["evaluator_launches"]["int8_matmul_requant"] == 0:
        raise AssertionError(f"qeval launched {rep['evaluator_launches']}")
    pred = serve.DetPredictor("qssd", artifact=base, device=dev)
    ds = qeval.eval_dataset("synthetic", "", DET_CLASSES, 8)
    served = evaluate_map(pred.feat, pred.head, ds, pred.priors.cpu().numpy(), INT8,
                          DET_CLASSES, dev)
    if served["mAP"] != ev["int8"]["mAP"] or \
            not np.array_equal(served["ap_per_class"], ev["int8"]["ap_per_class"]):
        raise AssertionError(f"served artifact mAP {served['mAP']} != the evaluator's INT8 "
                             f"mAP {ev['int8']['mAP']}")
    rep["evaluate"] = {"qat": ev["qat"]["mAP"], "int8": ev["int8"]["mAP"],
                       "served_int8": served["mAP"], "export_bytes": ev["export_bytes"]}
    # the calibrated fixture's nets detect more than five trained iterations
    # do: the same check where the mAP is not 0
    fix_base = os.path.join(root, "fixture")
    fv, hv = det_variables("qssd")
    fev = qeval.evaluator("qssd", feat_vars=fv, head_vars=hv, export_int8_path=fix_base,
                          batch_size=8, device=dev)
    fpred = serve.DetPredictor("qssd", artifact=fix_base, device=dev)
    fserved = evaluate_map(fpred.feat, fpred.head, ds, fpred.priors.cpu().numpy(), INT8,
                           DET_CLASSES, dev)
    if fserved["mAP"] != fev["int8"]["mAP"] or not fserved["mAP"] > 0:
        raise AssertionError(f"fixture: served artifact mAP {fserved['mAP']} != the "
                             f"evaluator's INT8 mAP {fev['int8']['mAP']}, or 0")
    rep["evaluate_fixture"] = {"qat": fev["qat"]["mAP"], "int8": fev["int8"]["mAP"],
                               "served_int8": fserved["mAP"]}
    dets = os.path.join(root, "detections.jsonl")
    rep["serve_main"] = serve.main(serve.build_parser().parse_args(
        ["--workload", "det", "--artifact", base, "--iters", "10", "--output", dets]))
    with open(dets) as f:
        lines = [json.loads(x) for x in f]
    if len(lines) != 4 * rep["serve_main"]["batch_size"]:  # --predict_batches 4
        raise AssertionError(f"serve --workload det wrote {len(lines)} lines")
    rep["served_detections"] = sum(len(r["detections"]) for r in lines)
    rep["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[det] trainer path: steps {rep['train_steps']}, resume {rep['resume_steps']} "
        f"(fake_quant_observe {n_sites} per QAT step); qeval launches "
        f"{rep['evaluator_launches']}; mAP QAT sim {rep['evaluate']['qat']:.4f}, INT8 "
        f"{rep['evaluate']['int8']:.4f}, the served artifact {served['mAP']:.4f} (equal); the "
        f"calibrated fixture's: QAT sim {fev['qat']['mAP']:.4f}, INT8 {fev['int8']['mAP']:.4f}, "
        f"served {fserved['mAP']:.4f} (equal); serve.main "
        f"--workload det: {rep['serve_main']['request_images_per_sec']} images/s a request, "
        f"{rep['served_detections']} detections in {len(lines)} images; peak memory "
        f"{rep['peak_memory_gib']:.2f} GiB")
    return rep


def time_dets(served, mm_rows, sites, dev):
    """Phase 18, timings: each net's INT8 forward (feature net and head) and
    the forward with ``detect`` at the server's settings at batch 1, 8 and
    32; one profiled forward at batch 8 (the matmul kernel, the torch ops,
    the idle share) and ``detect`` alone at the server's and the
    evaluator's settings (its device time and launches); the matmul kernel
    at each distinct matmul of the batch-8 forwards and the fake-quant kernel
    at the qssd sites of part b, beside their bounds, plain versions and
    library calls."""
    from frostnet_tpu_torch.detection.nms import detect

    out = {"serving": {}}
    for net, pred in served.items():
        rec = {}
        for b in (1, 8, 32):
            xb = torch.as_tensor(det_images(5, b), device=dev)
            ms = time_ms(lambda: pred(xb), reps=10, warmup=1)
            ms_det = time_ms(lambda: pred.detect(xb), reps=10, warmup=1)
            rec[f"bs{b}"] = {"ms_per_batch": ms, "images_per_sec": b / ms * 1e3,
                             "with_detect_ms": ms_det, "with_detect_images_per_sec":
                             b / ms_det * 1e3}
            log(f"[time] {net} INT8 forward at {DET_SIZE}x{DET_SIZE}, batch {b}: {ms:.3f} "
                f"ms/batch ({b / ms * 1e3:.2f} images/s); with detect {ms_det:.3f} ms/batch "
                f"({b / ms_det * 1e3:.2f} images/s)")
            del xb
        x8 = torch.as_tensor(det_images(6, 8), device=dev)
        try:
            rec["profile"] = profile_forward(pred, x8, MB_KERNELS)
            log_profile(f"{net} INT8 forward at batch 8", rec["profile"])
            loc, conf = pred(x8)
            scores = torch.softmax(conf, dim=-1)
            for tag, kw in (("serve", DET_SERVE), ("eval", dict(conf_thresh=0.01, top_k=200))):
                rec[f"nms_{tag}"] = profile_forward(
                    lambda _x, kw=kw: detect(loc, scores, pred.priors, **kw), x8, {})
                log_profile(f"{net} detect {kw} at batch 8", rec[f"nms_{tag}"])
        except RuntimeError as e:  # torch.profiler stops recording after many sessions
            log(f"[time] {net}: no profile ({e})")
            rec["profile"] = None
        out["serving"][net] = rec
        del x8
    rows = []
    for label, a, op in mm_rows:
        rows.append(kernel_row(f"{label} {matmul_shape(a, op)}", lambda: int8_matmul_requant(a, op),
                               lambda: int8_matmul_requant_plain(a, op),
                               matmul_cost(a.shape[0], op.k, op.n), int_mm_ms(a, op.wt, reps=10),
                               reps=10, plain_reps=1))
        rows[-1]["path"] = "det"
        log(f"[time] int8_matmul_requant {rows[-1]['shape']}: {row_text(rows[-1])}")
    out["fake_quant"] = fq = time_fake_quant_sites(sites)
    lib = "n/a" if fq["library_ms"] is None else (
        f"{fq['library_ms']:.4f} device, {fq['library_wall_ms']:.4f} wall")
    log(f"[time] fake_quant_observe, the {len(sites)} sites of a qssd QAT forward at batch "
        f"{sites[0][0].shape[0]} ({DET_SIZE}x{DET_SIZE}, float32): {fq['ms']:.4f} ms device, "
        f"{fq['graph_ms']:.4f} graph, {fq['wall_ms']:.4f} wall ({fq['launches_per_site']} launch "
        f"a site; bound {fq['bound_ms']:.4f} {fq['bound_by']}, {100 * fq['bound_share']:.1f}%; "
        f"plain {fq['plain_ms']:.3f}, fused_moving_avg_obs_fake_quant {lib})")
    for line in bucket_lines(fq):
        log(f"    {line}")
    return rows, out


def det_phase(dev):
    """Phase 18: detection on the card (serving against the JAX digests, the
    matmul and fake-quant kernels at the detection shapes, training against
    the JAX reference, the timed steps, the trainer -> evaluator -> server
    path, times). Returns (report, launches of each path, matmul timing
    rows)."""
    rep, launches = {}, {}
    os.makedirs(PHASE18_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep["serving"], served = serve_dets(dev)
    launches["serving"] = {n: r["launches"] for n, r in rep["serving"].items()}
    rep["matmul_max_abs_err"], rep["matmul_shapes"], mm_rows = check_det_matmuls(served, dev)
    log(f"[det] int8_matmul_requant == plain at every matmul of both forwards at batch 8 and "
        f"32, aligned and unaligned rows: {rep['matmul_shapes']}")
    rep["fake_quant_max_abs_err"], sites = check_det_fake_quant(dev)
    largest = max((x for x, _, _, _ in sites), key=lambda x: x.numel())
    log(f"[det] fake_quant_observe == plain at all {len(sites)} sites of a qssd QAT forward at "
        f"batch 32 (float32; QAT and QAT_FROZEN passes); largest {tuple(largest.shape)} "
        f"({largest.numel() / 1e6:.1f} M elements)")
    ops.reset_launch_counts()
    rep["training_reference"] = train_det_against_reference(dev)
    launches["training"] = ops.launch_counts()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    rep["train_steps"] = time_det_steps(dev)
    launches["train_steps"] = ops.launch_counts()
    ops.reset_launch_counts()
    rep["trainer"] = det_trainer_path(dev)
    launches["trainer"] = ops.launch_counts()
    for path in ("training", "train_steps", "trainer"):
        if launches[path]["fake_quant_observe"] == 0:
            raise AssertionError(f"phase 18's {path} path launched no fake_quant_observe")
    if launches["trainer"]["int8_matmul_requant"] == 0:
        raise AssertionError("phase 18's trainer path launched no int8_matmul_requant")
    torch.cuda.empty_cache()
    mm, rep["timing"] = time_dets(served, mm_rows, sites, dev)
    del served, sites, mm_rows
    torch.cuda.empty_cache()
    return rep, launches, mm


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
    report["ptxas_fake_quant"] = ptxas_kernels("fake_quant")
    for row in report["ptxas_fake_quant"]:
        log(f"[ptxas fake_quant] {row['kernel']}: {row['registers']} registers, {row['smem']} "
            f"bytes static shared memory, spills {row['spill_stores']}/{row['spill_loads']} bytes")
    report["sass"] = check_sass()
    log(f"[build] int8 tensor-core instructions, no dp4a: {report['sass']}")

    # 3a. the block kernel at the 18 main-path shapes, batch 1, 8 and 128,
    # qnnpack and fbgemm
    max_err = {"frost_block_int8": 0, "int8_matmul_requant": 0}
    block_specs = {}
    for backend in ("qnnpack", "fbgemm"):
        net = create_model(MODEL, qconfig=get_qconfig(backend))
        block_specs[backend] = net.block_specs(IMAGE)
        clusters = set()
        for batch in BLOCK_BATCHES:
            for i, (name, spec) in enumerate(block_specs[backend]):
                x, p = random_block_case(spec, batch, seed=i, device=dev)
                err = check_equal(f"{backend} {name} batch {batch}", frost_block_int8(x, p, spec),
                                  frost_block_int8_plain(x, p, spec))
                max_err["frost_block_int8"] = max(max_err["frost_block_int8"], err)
                clusters.add(plan_launch(spec, batch, sm_count(dev.index or 0)).cluster)
            torch.cuda.synchronize()
        log(f"[check] frost_block_int8 == plain at {len(block_specs[backend])} shapes x batch "
            f"{BLOCK_BATCHES} ({backend}); clusters of {sorted(clusters)} CUDA blocks")

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
                                  frost_block_int8(inp.q, mod._params, mod._spec),
                                  frost_block_int8_plain(inp.q, mod._params, mod._spec))
                max_err["frost_block_int8"] = max(max_err["frost_block_int8"], err)
            elif mod._route in ("matmul", "im2col"):
                a = matmul_operand(mod, inp.q)
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

    # 3c. the matmul kernel at shapes that cut its tiles
    err, checked = check_matmul_edges(dev)
    max_err["int8_matmul_requant"] = max(max_err["int8_matmul_requant"], err)
    log(f"[check] int8_matmul_requant == plain at {checked} edge cases: {MATMUL_EDGES}, u8/s8, "
        f"qnnpack/fbgemm, aligned and unaligned rows")

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
    expect = {True: {"frost_block_int8": 18, "int8_matmul_requant": 3, "fake_quant_observe": 0,
                     "int8_conv": 0},
              False: {"frost_block_int8": 0, "int8_matmul_requant": 52, "fake_quant_observe": 0,
                      "int8_conv": 0}}
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
        plan = plan_launch(spec, BATCH, sm_count(dev.index or 0))
        row = kernel_row(f"{name} {spec.h}x{spec.w}x{spec.cin}->{spec.cout} E={spec.c_e} "
                         f"k{spec.kernel}s{spec.stride}", lambda: frost_block_int8(x, p, spec),
                         lambda: frost_block_int8_plain(x, p, spec), block_cost(spec, BATCH),
                         (None, None), reps=50, plain_reps=3)
        row.update(cluster=plan.cluster, grid=plan.grid, smem=plan.smem)
        timing["frost_block_int8"].append(row)
        log(f"[time] frost_block_int8 {row['shape']} (cluster {plan.cluster}, grid {plan.grid}, "
            f"{plan.smem} B shared): {row_text(row)}")
    block_sums = {}
    for b in (1, 128):
        got = time_blocks(block_specs["qnnpack"], b, time_ms, graph_ms)
        block_sums[f"bs{b}"] = {"wall_ms": got["wall_ms"], "device_ms": got["device_ms"]}
        log(f"[time] frost_block_int8, the 18 blocks at batch {b}: {got['wall_ms']:.4f} ms wall, "
            f"{got['device_ms']:.4f} device")
    report["block_ms_sums"] = block_sums
    for fuse in (True, False):
        for name, a, op in mm_shapes[fuse]:
            entry = kernel_row(f"{name} {matmul_shape(a, op)}", lambda: int8_matmul_requant(a, op),
                               lambda: int8_matmul_requant_plain(a, op),
                               matmul_cost(a.shape[0], op.k, op.n), int_mm_ms(a, op.wt, reps=50),
                               reps=50, plain_reps=3)
            entry["path"] = "fused" if fuse else "unfused"
            timing["int8_matmul_requant"].append(entry)
            log(f"[time] int8_matmul_requant {entry['path']} {entry['shape']}: {row_text(entry)}")
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
    x8 = torch.as_tensor(np.random.RandomState(2).randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32),
                         device=dev)
    report["fused_profile"] = profile_forward(preds[True], x8, FROSTNET_KERNELS)
    log_profile(f"fused forward at batch {BATCH}", report["fused_profile"])

    # 7. the fake-quant kernel at every per-tensor site of a full-width QAT forward
    checked, max_err["fake_quant_observe"], largest, replayed = check_fake_quant(dev)
    report["fake_quant_graph_replay"] = replayed
    log(f"[check] fake_quant_observe == plain at {checked} site checks (2 QAT forwards x "
        f"{N_SITES} sites x float32/bfloat16; QAT and QAT_FROZEN passes), STE gradient at "
        f"{largest}; two CUDA-graph replays == plain applied twice at {replayed}")

    # 8. the training main path against the committed JAX reference
    state, train_counts, report["train_check"] = train_against_reference(dev)
    log(f"[train] launches over the training run: {train_counts}")
    if train_counts["fake_quant_observe"] == 0:
        raise AssertionError("the training run launched no fake-quant kernel")

    # 9. freeze the trained model and serve it
    report["trained_serving_launches"] = serve_trained(state, dev)
    del state
    torch.cuda.empty_cache()

    # 10. the benchmarked training step
    report["training"] = time_training(dev)
    fq_time = report["training"]["bs128"]["fake_quant"]
    torch.cuda.empty_cache()

    # The GAN phases run with cuDNN's TF32 at its default (allowed): the
    # generator's float tail turns it off for its own conv.
    torch.backends.cudnn.allow_tf32 = True

    # 11. the dense 3x3 conv kernel at the GAN's 20 shapes, an fbgemm grid, a
    # ragged shape; the matmul kernel at the GAN's 3 im2col convs
    gan = GanPredictor(GAN, artifact=GAN_ARTIFACT, image_size=GAN_IMAGE, device=dev)
    max_err["int8_conv"], checked, conv_shapes = check_int8_conv(gan, dev)
    log(f"[check] int8_conv == plain at {checked} cases: the {len(conv_shapes)} convs of the "
        f"GAN forward (batch {GAN_BATCH}) on the fixture's inputs and on an fbgemm grid with "
        f"and without ReLU, and two ragged shapes; shapes "
        f"{sorted(set(s[1:] for s in conv_shapes))}")
    err, gan_mm_shapes = check_gan_matmuls(gan, gan_images(0, GAN_BATCH), dev)
    max_err["int8_matmul_requant"] = max(max_err["int8_matmul_requant"], err)
    log(f"[check] int8_matmul_requant == plain at the GAN's {len(gan_mm_shapes)} im2col convs "
        f"(batch {GAN_BATCH}), on the fixture's inputs and on an fbgemm grid with and without "
        f"ReLU: {gan_mm_shapes}")

    # 12. the GAN main path
    gan_counts, report["gan_tail_err"], report["gan_tail_err_tf32"] = serve_gan(gan)
    report["gan_serve_main"] = serve.main(serve.build_parser().parse_args(
        ["--workload", "gan", "--artifact", GAN_ARTIFACT, "--iters", "20"]))

    # 13. GAN timings
    (timing["int8_conv"], gan_mm_rows, report["gan_throughput"],
     report["gan_profile"]) = time_gan(gan, dev)
    timing["int8_matmul_requant"] += gan_mm_rows

    # 14. the classification trainer and evaluator through their entry points
    del gan
    torch.cuda.empty_cache()
    report["trainer"], trainer_counts = trainer_phase(dev)

    # 15. the MobileNets: serving, the fake-quant sites, training, the user's path
    torch.cuda.empty_cache()
    report["mobilenet"], mb_counts = mobilenet_phase(dev)
    max_err["int8_matmul_requant"] = max(max_err["int8_matmul_requant"],
                                         report["mobilenet"]["matmul_max_abs_err"])
    max_err["fake_quant_observe"] = max(max_err["fake_quant_observe"],
                                        report["mobilenet"]["fake_quant_max_abs_err"])

    # 16. the ResNets: serving, the kernels at their shapes, the grouped
    # route, the fake-quant sites, training, the user's path, timings
    torch.cuda.empty_cache()
    report["resnet"], rn_counts, rn_conv_rows, rn_mm_rows = resnet_phase(dev)
    timing["int8_conv"] += rn_conv_rows
    timing["int8_matmul_requant"] += rn_mm_rows
    for k, v in report["resnet"]["max_abs_err"].items():
        max_err[k] = max(max_err[k], v)
    max_err["fake_quant_observe"] = max(max_err["fake_quant_observe"],
                                        report["resnet"]["fake_quant_max_abs_err"])

    # 17. segmentation: serving against the JAX digests at 768x768, the
    # kernels at its shapes, training, the trainer and evaluator, timings
    torch.cuda.empty_cache()
    report["seg"], seg_counts, seg_mm_rows = seg_phase(dev)
    timing["int8_matmul_requant"] += seg_mm_rows
    max_err["int8_matmul_requant"] = max(max_err["int8_matmul_requant"],
                                         report["seg"]["matmul_max_abs_err"])
    max_err["fake_quant_observe"] = max(max_err["fake_quant_observe"],
                                        report["seg"]["fake_quant_max_abs_err"])

    # 18. detection: serving both nets against the JAX digests at 300x300,
    # the kernels at their shapes, training, the trainer, evaluator and
    # server, timings
    torch.cuda.empty_cache()
    report["det"], det_counts, det_mm_rows = det_phase(dev)
    timing["int8_matmul_requant"] += det_mm_rows
    max_err["int8_matmul_requant"] = max(max_err["int8_matmul_requant"],
                                         report["det"]["matmul_max_abs_err"])
    max_err["fake_quant_observe"] = max(max_err["fake_quant_observe"],
                                        report["det"]["fake_quant_max_abs_err"])

    def summary(name, source, replaces, paths, launches):
        """One kernel's entry over the timing rows of its main paths (each
        row at its path's batch) and the launches of one forward of each:
        ``ms`` and ``library_ms`` wall, and where the rows have it
        ``device_ms`` and ``library_device_ms``."""
        rows = [r for r in timing[name] if r.get("path") in paths]

        def total(key):
            vals = [r[key] for r in rows]
            return None if None in vals else sum(vals)

        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "max_abs_err": max_err[name], "ms": total("ms"),
                 "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                 "bound_by": "bytes" if by_bytes * 2 >= total("bound_ms") else "operations",
                 "library_ms": total("library_ms")}
        if "device_ms" in rows[0]:
            entry.update(device_ms=total("device_ms"), library_device_ms=total("library_device_ms"))
        return entry

    kernels = {"kernels": [
        summary("frost_block_int8", BLOCK_SOURCE, BLOCK_REPLACES, (None,),
                counts[True]["frost_block_int8"]),
        summary("int8_matmul_requant", MATMUL_SOURCE, MATMUL_REPLACES, ("fused", "gan"),
                counts[True]["int8_matmul_requant"] + gan_counts["int8_matmul_requant"]),
        {"name": "fake_quant_observe", "route": "cuda", "source": FQ_SOURCE,
         "replaces": FQ_REPLACES, "launches": train_counts["fake_quant_observe"],
         "max_abs_err": max_err["fake_quant_observe"], "ms": fq_time["ms"],
         "plain_ms": fq_time["plain_ms"], "bound_ms": fq_time["bound_ms"],
         "bound_by": fq_time["bound_by"], "library_ms": fq_time["library_ms"],
         "device_ms": fq_time["graph_ms"], "wall_ms": fq_time["wall_ms"]},
        summary("int8_conv", CONV_SOURCE, CONV_REPLACES, (None,), gan_counts["int8_conv"])]}
    for entry in kernels["kernels"]:
        entry["trainer_launches"] = trainer_counts[entry["name"]]
        for key, path_counts in (("mobilenet_launches", mb_counts),
                                 ("resnet_launches", rn_counts), ("seg_launches", seg_counts),
                                 ("det_launches", det_counts)):
            entry[key] = {path: (sum(c[entry["name"]] for c in counts.values())
                                 if path == "serving" else counts[entry["name"]])
                          for path, counts in path_counts.items()}
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
