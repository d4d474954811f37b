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
 19. GAN training at 256x256 (float32, TF32 off): (a) the fake-quant kernel
     against its plain version, bit for bit, at the 58 per-tensor sites of a
     ``resnet_9blocks`` QAT forward at batch 1 and 4 (y, mask, observers,
     qparams, the QAT_FROZEN pass) and the STE gradient of the largest site;
     (b) pix2pix (``resnet_9blocks`` at ngf 64, the ``basic`` PatchGAN with
     BN at ndf 64, batch 1) from the GAN numpy init at seed 0 against the
     committed JAX reference (``testdata/gan_pix2pix_train_reference.npz``):
     one FP32 iteration, ``set_warmup(False)``, two QAT iterations and a
     QAT_FROZEN forward, in the ``GAN_*`` bands, with 0 fake-quant launches
     an FP32 iteration and two a site a QAT one, and G's buffers unchanged by
     each ``d_step``; (c) CycleGAN (two such generators, two Ds without norm)
     against ``testdata/gan_cyclegan_train_reference.npz``: one FP32 and one
     QAT iteration with the image pools, six launches a site a QAT
     ``g_step``; (d) ``gan.train.main`` (pix2pix, 2 steps an epoch, one FP32
     and one QAT epoch), its ``--continue_train`` to a second QAT epoch
     against an uninterrupted run (losses bit for bit), ``gan.test.main
     --export_int8`` on ``latest_G`` (gallery, artifact), ``serve.main
     --workload gan`` on it against the in-process ``freeze`` (bit for bit,
     20 + 3 launches a forward) and ``eval_cityscapes.score_pairs`` on the
     tester's outputs with the calibrated ``mobilenetv3_RE_small``; (e)
     pix2pix FP32 and QAT iterations at batch 1 and 8, the CycleGAN QAT
     iteration at batch 1 (ms, images/s, peak memory), the fake-quant kernel
     at the batch-1 sites, and one profiled pix2pix QAT iteration (the
     fake-quant kernel, cuDNN's convs, the other torch ops, idle share);
 20. the rest of the zoo (``zoo_phase``), from the committed JAX fixtures
     (``testdata/zoo_*``, ``tests/test_torch_zoo_fixture.py``): (a)
     ``qvgg16_bn``, ``qshufflenet_v2_x1_0`` and ``qalexnet`` served at
     224x224, batch 8, from the port's export: every layer's codes equal
     the JAX digests, the logits within one step of the last ``QDense``'s
     grid, one forward's launches as the routes say, ``serve.main
     --workload cls`` on each artifact equal to the predictor, the dense
     conv and the matmul against their plain versions at every call; (b)
     the dense conv at each of VGG16's shapes timed (bound, plain,
     ``torch._int_mm``); (c) ``espnetv2`` (s 2.0) and ``espnet`` (p 2, q 8)
     at 768x768, batch 2: every module's codes equal the digests, the
     logits and argmax in phase 17's bands, the launches, the ``grouped``
     route's time beside the forward's, a profile; (d) the dense conv
     bit-exact to its plain version at the odd channel counts 3 -> 64 (VGG),
     3 -> 3 (ESPNetv2's reinforcement), 38 -> 19 (ESPNet's decoder) and
     39 -> 20, aligned and not, and timed; (e) one QAT step of each
     classifier and of ``espnetv2_s_2_0`` (with a QAT_FROZEN forward), one
     FP32 step of each float-only baseline; (f) ESPNetv2's and ESPNet's
     FP32 and QAT steps against ``testdata/zoo_<model>_train_reference.npz``
     in phase 8's bands; (g) ``segmentation.train.main`` and ``evaluate.main`` on
     ``espnetv2 --width_scale 2.0`` at 768x768. Each path's launches are
     counted from 0.
 21. the rest of serving and the model tools (``tools_phase``), with TF32
     off: (a) ``serve.main --workload seg`` on ``mobilenetv3_large`` at
     512x1024 (the JAX server's default), batch 8, full width and depth,
     over the port's export of the committed calibration
     (``testdata/seg_mobilenetv3_large_calibration.npz``): images/s, p50 and
     p95, the matmul launches a forward (one per 1x1 or im2col conv), the 8
     class-map PNGs; then the same model's kernel path against its plain
     path on the card (``plain_kernels``: the wrappers' plain versions):
     every layer's codes, the logits and the class maps equal; (b) the
     serialized program (``quant/serialize.py``, ``torch.export`` with the
     kernels as ``torch.library`` ops) of the committed INT8 fixture, fused
     and unfused, exported once on a symbolic batch and served by
     ``serve.main --program`` at batch 8 and 128: the logits equal the
     in-process ``Int8Predictor``'s bit for bit, the launches a forward 18
     blocks + 3 matmuls and 52 matmuls, the pipelined ms a batch beside the
     in-process model's; (c) ``FrostNet(output_stride=16|8)`` with
     ``features_only`` from the fixture's variables at 224x224 (batch 8) and
     512x512 (batch 2), INT8 with ``fuse_int8``: the four features equal
     the plain path, the block kernel launched at the undilated blocks
     only, the matmul at the stem and the dilated blocks' 1x1s; (d) the
     numeric suite on the fixture at batch 8, INT8 against QAT_FROZEN (166
     fake-quant and 52 matmul launches), its rows' paths and shapes equal
     to the CPU run's, the worst 5 printed; (e) ``latency_check.main``
     (fbgemm, batch 1) for ``qmobilenet_v2_ReLU`` and
     ``frostnet_quant_large_1_0``: FP32, QAT_FROZEN and INT8 ms a batch.
 22. the native loaders and data parallelism (``dp_phase``): (a) the C++
     loaders of ``native/``: where g++ finds no libjpeg and libpng (the
     card's machine has neither), a line says so, and the build and
     ``loader='native'`` raise with the compiler's message (no fallback);
     where it finds them, the seg and det pools on PNGs written here (the
     rank blocks at ``threads=1`` concatenate to the batch; images/s with
     32 threads); (b) two ranks (``dp_rank``, one process each, gloo on
     ``cuda:0``) run the FP32 step and two QAT steps of
     ``frostnet_quant_large_1_0`` on a global batch of 128 with phase 8's
     settings: their parameters, BN statistics and observers bit-identical,
     within phase 8's bands of the one-process steps on the same batches,
     and every fake-quant site of the first QAT step bit-exact to its plain
     version (the data-parallel route at the activation sites, on the
     all-reduced min and max; the one-launch kernel at the weight sites),
     with each step's launches and host time (a correctness path); then
     the data-parallel route's two kernels at a rank's activation sites
     timed as a CUDA graph beside the one-launch kernel; (c) ``serve --dp
     2`` with both replicas on ``cuda:0`` (``devices=``): fused FrostNet at
     batch 8 (36 + 6 launches) and 7, the GAN at batch 2, bit-equal to one
     replica; (d) ``torchrun --nproc_per_node 2 -m
     frostnet_tpu_torch.train.classification`` with both ranks on this card
     (gloo), a global batch of 64, one FP32 and one QAT epoch of 2 steps:
     exit 0, the checkpoint and the log from rank 0 alone, the epochs'
     images/s.
 23. the last configurations (``last_configs_phase``): (a) ``torchrun
     --nproc_per_node 2`` (gloo, both ranks on ``cuda:0``) of each trainer's
     ``main`` at full width, 2 steps a phase, all five started together:
     segmentation (768x768, global batch 8), detection (``qssd``, 300x300,
     batch 32), pix2pix and CycleGAN (256x256, batch 2), and pix2pix at
     batch 1 (JAX's mesh takes one device: rank 1 idles and writes nothing);
     each exits 0, its ranks end bit-identical, its save directory holds
     what the one-process run's does with as many log records (rank 0
     alone wrote), its losses, observers and BN statistics stay within
     phase 17's, 18's or 19's bands of that run (the same trainer in this
     process on the same global batches), and every fake-quant site of its
     first QAT step equals the plain version; (b) tensor parallelism:
     ``frostnet_quant_large_1_0`` at 224x224 with phase 8's settings,
     warmed in this process (an FP32 and four QAT steps), then a QAT step
     (every site checked) and a QAT_FROZEN forward on a global batch of 16,
     on mp 2 (two ranks), dp 2 x mp 2 (four) and dp 2 x mp 1 (two), started
     together: mp 2 against the one-process step and dp 2 x mp
     2 against dp 2 x mp 1, ``test_multihost``'s bands (loss rtol 1e-6,
     logits atol 1e-5, each variable atol 1e-4 of max(|v|, 1)) printed and
     phase 22's held, the ranks of a layout holding the same gathered
     variables, each rank's launches; (c) ``remat``: phase 10's bf16 QAT
     step at batch 256, plain, ``"full"`` and ``"conv_outs"``, with
     ``cudnn.deterministic``: each step's loss and variables against plain
     (a difference is printed), peak memory and ms a step; (d) the INT8
     routes the port once refused (padded 1x1s, a dilated grouped 3x3,
     depthwise 3x5 and a valid 5x5 stride 2), frozen on the card and on the
     CPU from the same variables: the codes bit-equal, the padded 1x1 one
     matmul launch, each depthwise route one depthwise launch.
 24. the INT8 depthwise kernel (``depthwise_phase``) against its plain
     version, bit for bit, at batch 8: on codes one byte into their
     storage (byte loads where aligned codes take words) and at the SSD
     extras' channel multiplier 4, then at the 15 depthwise convs of the
     benchmark's segmentation serving cell (``mobilenetv3_large``, dilated,
     512x1024; ``scripts/time_depthwise_int8.py``, whose ``run`` checks and
     times each: profiler device ms where the profiler still records, a
     CUDA graph's ms, the plain chain's device ms and launches, the bound of
     ``depthwise_roofline.serve``).
 25. the bilinear resize kernel (``resize_phase``) at the segmentation
     cell's three resizes at batch 8 (``scripts/time_resize_bilinear.py``:
     bit for bit against its plain version, then profiler device ms, a CUDA
     graph's ms, the plain chain's device ms and launches,
     a graph's ms of ``F.interpolate``, the bound of ``resize_roofline.serve``).
Every path's launch counts hold the depthwise kernel's beside the others'
(one launch per INT8 depthwise conv of a forward), and the resize kernel's
(one launch per resize of a forward, training steps included).
The ``kernels`` line sums each kernel over its main paths: the matmul
kernel over the fused FrostNet forward (batch 8) and the GAN forward
(batch 8 for times, one forward each for launches). Its ``ms`` and
``library_ms`` are wall times of back-to-back calls, except the fake-quant
kernel's and the depthwise kernel's, which are torch.profiler device time
(the depthwise kernel's null where the profiler records nothing any more,
as it may at the end of this long process);
the block, matmul and conv entries add ``device_ms`` and
``library_device_ms``, the fake-quant entry ``device_ms`` (a replayed CUDA
graph of the sites) and ``wall_ms``, the depthwise entry ``device_ms`` (one
replayed CUDA graph of the 15 segmentation shapes; its launches those of a
phase 21 seg serving forward), the resize entry the same over its 3 shapes
(``library_ms`` a CUDA graph's ms of ``F.interpolate``, which rounds otherwise). A
matmul's bound counts its own K, not the zero columns the im2col route pads
rows with.
Each entry also gives ``trainer_launches``, its launches in phase 14,
``mobilenet_launches``, its launches on each path of phase 15 (the two
served forwards, each model's training, the trainer path),
``resnet_launches``, the same for phase 16, ``seg_launches``, its
launches on phase 17's paths (the two served forwards, the training check
against the reference, the trainer path), and ``det_launches``, the same for
phase 18 (the two served forwards, the training check, the timed steps, the
trainer path), ``gan_train_launches``, the same for phase 19 (the two
training checks, the trainer path, the tester and server), and
``zoo_launches``, the same for phase 20 (each served forward, each training
step, the two training checks, the ESPNetv2 trainer path), and
``tools_launches``, the same for phase 21 (the seg server, each program at
each batch, each dilated forward, the numeric suite, each latency probe),
and ``dp_launches``, the same for phase 22 (each step of a rank, with the
fake-quant kernel's data-parallel route as ``fake_quant_dp_route``, and
each ``serve --dp 2`` forward), and ``last_configs_launches``, the same for
phase 23 (each rank of each torchrun trainer, each rank of each ``mp``
layout, each ``remat`` step, each INT8 route).
Phase 20 alone, after the build: ``python3 -c "import torch, chip_smoke as c;
c.cuda_build.build(c.cuda_build.SOURCES); print(c.zoo_phase(torch.device('cuda'))[1])"``
(``tools_phase`` for phase 21, ``dp_phase`` for phase 22, ``last_configs_phase``
for phase 23); phase 24 alone: ``python3 scripts/time_depthwise_int8.py``;
phase 25 alone: ``python3 scripts/time_resize_bilinear.py``.
It prints a ``kernels`` JSON line, the card line, and last the device JSON.
Details go to ``build/chip_smoke.json`` (``--out`` puts them elsewhere).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
from frostnet_tpu_torch.ops.depthwise_int8 import (depthwise_int8, depthwise_int8_plain,
                                                   depthwise_operands)
from frostnet_tpu_torch.ops.fake_quant import (ObservedFakeQuant, fake_quant_observe,
                                               fake_quant_observe_plain, plan_fake_quant)
from frostnet_tpu_torch.ops.frost_block import (frost_block_int8, frost_block_int8_plain,
                                                plan_launch, random_block_case, sm_count)
from frostnet_tpu_torch.ops.int8_conv import (conv3x3_operands, conv3x3_s1_int8,
                                              conv3x3_s1_int8_plain)
from frostnet_tpu_torch.ops.int8_matmul import (conv1x1_operands, int8_matmul_requant,
                                                int8_matmul_requant_plain)
from frostnet_tpu_torch.ops.resize import resize_bilinear_plain
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import (ObserverState, QParams, QTensor, export_int8, freeze,
                                      from_jax_variables, get_qconfig, model_variables, numpy_init)
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
from frostnet_tpu_torch.quant.observer import global_batch_min_max
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
DW_SOURCE = "frostnet_tpu_torch/csrc/depthwise_int8.cu"
DW_REPLACES = "frostnet_tpu/nn/conv.py:423 (XLA code; no TPU kernel)"
RESIZE_SOURCE = "frostnet_tpu_torch/csrc/resize_bilinear.cu"
RESIZE_REPLACES = "frostnet_tpu/ops/resize.py:36 (XLA code; no TPU kernel)"
GAN = "resnet_9blocks"
GAN_ARTIFACT = os.path.join(TESTDATA, f"{GAN}_int8.npz")
GAN_REFERENCE = os.path.join(TESTDATA, f"{GAN}_reference.npz")
GAN_IMAGE, GAN_BATCH = 256, 4
GAN_LAUNCHES = {"int8_matmul_requant": 3, "frost_block_int8": 0, "fake_quant_observe": 0,
                "int8_conv": 20, "depthwise_int8": 0, "resize_bilinear": 2}
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
        def apply(x, obs, spec, observe, mesh=None):
            sites.append((x.detach().clone(), obs.min_val.detach().clone(),
                          obs.max_val.detach().clone(), spec))
            return real.apply(x, obs, spec, observe, mesh)

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
            "int8_conv": 0, "depthwise_int8": 0, "resize_bilinear": 0}
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
    library_all = fq_library_call(sites)
    try:
        out["library_ms"] = device_ms(library_all)
        out["library_wall_ms"] = time_ms(library_all, reps=5)
    except RuntimeError as e:
        log(f"[time] torch.fused_moving_avg_obs_fake_quant refused: {e}")
        out["library_ms"] = out["library_wall_ms"] = None
    return out


def fq_library_call(sites):
    """``torch.fused_moving_avg_obs_fake_quant`` over ``sites`` on float32
    copies: the yardstick only, the port never calls it."""
    dev = sites[0][0].device
    on = torch.ones(1, dtype=torch.long, device=dev)
    args = [(x.to(torch.float32), mn.reshape(1).clone(), mx.reshape(1).clone(),
             torch.ones(1, device=dev), torch.zeros(1, dtype=torch.int32, device=dev), spec)
            for x, mn, mx, spec in sites]

    def library_all():
        for xf, rmin, rmax, scale, zp, spec in args:
            torch.fused_moving_avg_obs_fake_quant(xf, on, on, rmin, rmax, scale, zp, 0.01,
                                                  spec.qmin, spec.qmax, 0, False, spec.symmetric)

    return library_all


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
    """One profiled call ``pred(x)``: device ms and launches of each of
    ``kernels`` (name -> a substring of its CUDA kernels' names, or a test
    of the name) and of the torch ops (and the torch ops' largest kernels),
    and the device's idle share. Annotations (an optimizer's step) span
    kernels and are left out."""
    pred(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pred(x)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("Optimizer.")]
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    split = {k: [0.0, 0] for k in list(kernels) + ["torch ops"]}
    by_name = {}
    for e in events:
        key = next((k for k, sub in kernels.items()
                    if (sub(e.name) if callable(sub) else sub in e.name)), "torch ops")
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
                 ("eval", INT8): {"fake_quant_observe": 0, "int8_matmul_requant": 52,
                                  "depthwise_int8": 18}}


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
MB_KERNELS = {"int8_matmul_requant": "int8_matmul_requant",
              "depthwise_int8": "depthwise_int8_kernel"}


def matmul_convs(model):
    """The convs of a frozen model that run the matmul kernel (1x1 and im2col)."""
    return [m for m in model.modules()
            if isinstance(m, QConvBNAct) and getattr(m, "_route", None) in ("matmul", "im2col")]


def depthwise_convs(model):
    """The convs of a frozen model that run the INT8 depthwise kernel."""
    return [m for m in model.modules()
            if isinstance(m, QConvBNAct) and getattr(m, "_route", None) == "depthwise"]


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
        n_mm, n_dw = len(matmul_convs(pred.model)), len(depthwise_convs(pred.model))
        ops.reset_launch_counts()
        logits, codes = layer_codes(pred, images)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expect = {"int8_matmul_requant": n_mm, "frost_block_int8": 0, "fake_quant_observe": 0,
                  "int8_conv": 0, "depthwise_int8": n_dw, "resize_bilinear": 0}
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
    zero = {"fake_quant_observe": 0, "int8_matmul_requant": 0, "int8_conv": 0,
            "depthwise_int8": 0, "resize_bilinear": 0}
    expect = {("train", FP32): zero,
              ("train", QAT): {**zero, "fake_quant_observe": n_sites},
              ("eval", QAT_FROZEN): {**zero, "fake_quant_observe": n_sites},
              ("eval", INT8): {**zero, "int8_matmul_requant": n_mm, "int8_conv": n_conv,
                               "depthwise_int8": len(depthwise_convs(probe))}}
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
    convs (the depthwise kernel), the hard-swishes and the squeeze-excites."""
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
    for k in ("fake_quant_observe", "int8_matmul_requant", "depthwise_int8"):
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
                                 "fake_quant_observe": 0, "int8_conv": 13, "depthwise_int8": 0,
                                 "resize_bilinear": 0},
                   "qresnet50": {"int8_matmul_requant": 40, "frost_block_int8": 0,
                                 "fake_quant_observe": 0, "int8_conv": 13, "depthwise_int8": 0,
                                 "resize_bilinear": 0}}
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
        n_mm, n_dw = len(matmul_convs(model)), len(depthwise_convs(model))
        ops.reset_launch_counts()
        logits, codes = seg_layer_codes(model, fn, images)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expect = {"int8_matmul_requant": n_mm, "frost_block_int8": 0, "fake_quant_observe": 0,
                  "int8_conv": 0, "depthwise_int8": n_dw, "resize_bilinear": resize_sites(model)}
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
    zero = {"fake_quant_observe": 0, "int8_matmul_requant": 0, "int8_conv": 0,
            "depthwise_int8": 0, "resize_bilinear": 0}
    rz = {**zero, "resize_bilinear": resize_sites(probe)}
    expect = {("train", FP32): rz,
              ("train", QAT): {**rz, "fake_quant_observe": n_sites},
              ("eval", QAT_FROZEN): {**rz, "fake_quant_observe": n_sites},
              ("eval", INT8): {**zero, "int8_matmul_requant": n_mm,
                               "depthwise_int8": len(depthwise_convs(probe)),
                               "resize_bilinear": resize_sites(probe)}}
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
    for k in ("fake_quant_observe", "int8_matmul_requant", "depthwise_int8"):
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
        n_mm, n_dw = len(matmul_convs(pred.feat)), len(depthwise_convs(pred.feat))
        ops.reset_launch_counts()
        (loc, conf), sources, codes = det_layer_codes(pred, images)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expect = {"int8_matmul_requant": n_mm, "frost_block_int8": 0, "fake_quant_observe": 0,
                  "int8_conv": 0, "depthwise_int8": n_dw,
                  "resize_bilinear": resize_sites(pred.feat)}
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
    zero = {"fake_quant_observe": 0, "int8_matmul_requant": 0, "int8_conv": 0,
            "depthwise_int8": 0, "resize_bilinear": 0}
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
            rep["evaluator_launches"]["int8_matmul_requant"] == 0 or \
            rep["evaluator_launches"]["depthwise_int8"] == 0:
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


# ---------------------------------------------------------------------------
# Phase 19: GAN training (pix2pix and CycleGAN QAT at 256x256)
# ---------------------------------------------------------------------------
GAN_PIX2PIX_REFERENCE = os.path.join(TESTDATA, "gan_pix2pix_train_reference.npz")
GAN_CYCLEGAN_REFERENCE = os.path.join(TESTDATA, "gan_cyclegan_train_reference.npz")
PHASE19_DIR = os.path.join(ROOT, "build", "phase19")
# the training references' configuration: the full-width nets at 256x256,
# batch 1, float32, QAdam (b1 0.5, the GradBoost noise off) and Adam at lr 2e-4
GAN_TRAIN = dict(netG=GAN, ngf=64, ndf=64, size=GAN_IMAGE, batch=1, seed=0, lr=2e-4, beta1=0.5)
GAN_SITES = 58  # per-tensor sites of one resnet_9blocks QAT forward
PIX2PIX_LOSSES = ("loss_D", "loss_G", "loss_G_GAN", "loss_G_L1")
CYCLEGAN_LOSSES = ("loss_G", "cyc_A", "cyc_B", "loss_D_A", "loss_D_B")
GAN_SAMPLE = 8  # the references keep every 8th row and column of an output
# Bands of phase 19's training checks against the committed JAX references
# (TF32 off). Measured, the port on the CPU (1 and 4 threads) / on the card
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §5), worst of pix2pix and CycleGAN:
# FP32 iteration losses 3.9e-5 / 1.5e-6 relative, BN statistics after it
# 9.0e-6 / 1.4e-6 of each tensor's largest, CycleGAN's fakes 2.4e-5 / 1.2e-5
# absolute: only the float sums' order differs. QAT iterations: losses
# 0.81% / 0.51%, observers 0.25% / 0.19% of their range in the median and
# 10.2% / 9.1% at worst, BN means 9.7e-4 of a std and variances 1.4e-3 in the
# median, the QAT_FROZEN output 0.103 / 0.092 at most and 0.021 / 0.021 in
# the mean after tanh: the observers snap to each forward's extremes, and one
# an ulp apart moves a grid and the layers after it (Queue C).
GAN_FP32_LOSS_REL = 2e-4
GAN_FP32_BN_REL = 1e-4        # max |d stat| / max |stat| after the FP32 iteration, worst
GAN_FAKE_ABS = 1e-4           # the FP32 iteration's fakes (CycleGAN), after tanh
GAN_QAT_LOSS_REL = 0.05
GAN_OBS_MEDIAN, GAN_OBS_WORST = 0.01, 0.3
GAN_BN_MEAN_MEDIAN, GAN_BN_VAR_MEDIAN = 0.01, 0.01
GAN_FROZEN_ABS, GAN_FROZEN_MEAN_ABS = 0.3, 0.06


def gan_train_nets(kind: str):
    """The nets of a training reference: pix2pix's (G, D), D conditional with
    BN; CycleGAN's (G_A, G_B, D_A, D_B), the Ds without norm."""
    from frostnet_tpu_torch.gan import define_d, define_g

    g = GAN_TRAIN
    if kind == "pix2pix":
        return define_g(ngf=g["ngf"], netG=g["netG"]), define_d(g["ndf"], norm="batch",
                                                                input_nc=6)
    return (define_g(ngf=g["ngf"], netG=g["netG"]), define_g(ngf=g["ngf"], netG=g["netG"]),
            define_d(g["ndf"], norm="none"), define_d(g["ndf"], norm="none"))


def gan_train_batches(n: int, batch: int = 1):
    """The first ``n`` batches of ``SyntheticPairs(256, ..., seed 0)``."""
    from frostnet_tpu_torch.gan import SyntheticPairs

    return list(SyntheticPairs(GAN_TRAIN["size"], n * batch, batch, GAN_TRAIN["seed"]))


def gan_optimizers():
    """(generator, discriminator) optimizer factories of the references."""
    g = GAN_TRAIN
    return (get_optimizer("QAdam", g["lr"], b1=g["beta1"], noise_decay=1.0),
            get_optimizer("Adam", g["lr"], b1=g["beta1"]))


def _prefixed(prefix: str, model, keep=("batch_stats/", "quant/")):
    """A copy of ``model``'s BN statistics and observers, keyed as the
    training references key them."""
    return {f"{prefix}/{k}": v.detach().cpu().numpy().copy() for k, v in
            model_variables(model).items() if k.startswith(keep)}


def gan_band_report(ref, losses, fp32_state, final_state, names, what, frozen=None):
    """Phase 19's bands against a committed JAX training reference: the
    FP32 iteration's losses and BN statistics, the QAT iterations' losses,
    every observer and BN statistic after the last, and (pix2pix) the
    QAT_FROZEN output. Returns the measured values."""
    rep = {}
    rel = {k: [abs(a / float(b) - 1) for a, b in zip(losses[k], ref[k])] for k in names}
    rep["loss_rel"] = rel
    log(f"[gan-train] {what} losses {losses}; relative to JAX {rel}")
    band_check(f"{what} FP32 iteration losses, worst relative to JAX",
               max(r[0] for r in rel.values()), GAN_FP32_LOSS_REL)
    band_check(f"{what} QAT iteration losses, worst relative to JAX",
               max(max(r[1:]) for r in rel.values()), GAN_QAT_LOSS_REL)
    fp = [float(np.max(np.abs(fp32_state[k] - ref[k])) / np.max(np.abs(ref[k])))
          for k in ref.files if k.startswith("fp32/")]
    rep["fp32_bn_rel_worst"] = max(fp)
    band_check(f"{what} BN statistics after the FP32 iteration, worst relative to JAX",
               max(fp), GAN_FP32_BN_REL)
    obs, bn_mean, bn_var = [], [], []
    for k in ref.files:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(ref[hi] - ref[k]), 1e-6)
            obs.append(max(abs(float(final_state[k] - ref[k])),
                           abs(float(final_state[hi] - ref[hi]))) / span)
        elif k.endswith("/mean") and not k.startswith("fp32/"):
            bn_mean.append(float(np.max(np.abs(final_state[k] - ref[k])
                                        / np.sqrt(ref[k[:-4] + "var"]))))
        elif k.endswith("/var") and not k.startswith("fp32/"):
            bn_var.append(float(np.max(np.abs(final_state[k] - ref[k]) / ref[k])))
    rep["observer_rel_range"] = {"median": float(np.median(obs)), "worst": float(max(obs)),
                                 "count": len(obs)}
    band_check(f"{what} observers, median |diff| / range", float(np.median(obs)), GAN_OBS_MEDIAN)
    band_check(f"{what} observers, worst |diff| / range", float(max(obs)), GAN_OBS_WORST)
    rep["bn"] = {"mean_over_std_median": float(np.median(bn_mean)),
                 "var_rel_median": float(np.median(bn_var)), "count": len(bn_mean)}
    band_check(f"{what} BN means, median |diff| / std", float(np.median(bn_mean)),
               GAN_BN_MEAN_MEDIAN)
    band_check(f"{what} BN variances, median |diff| / var", float(np.median(bn_var)),
               GAN_BN_VAR_MEDIAN)
    if frozen is not None:
        diff = np.abs(frozen - ref["frozen_out_sampled"])
        rep["frozen_abs"] = {"max": float(diff.max()), "mean": float(diff.mean())}
        band_check(f"{what} QAT_FROZEN output, max |diff|", rep["frozen_abs"]["max"],
                   GAN_FROZEN_ABS)
        band_check(f"{what} QAT_FROZEN output, mean |diff|", rep["frozen_abs"]["mean"],
                   GAN_FROZEN_MEAN_ABS)
    return rep


def pix2pix_against_reference(dev):
    """Phase 19, part b (and ``tests/test_torch_gan_train_fixture.py`` on the
    CPU): pix2pix from the GAN numpy init at seed 0 against the committed JAX
    reference: one FP32 iteration (``d_step``, ``g_step``),
    ``set_warmup(False)``, two QAT iterations and a QAT_FROZEN forward, in
    the bands above; G's BN statistics and observers the same before and
    after each ``d_step`` (hazard 1); on the card, the fake-quant launches of
    each iteration (0, then two a site)."""
    from frostnet_tpu_torch.gan.models import make_net_state, make_pix2pix_steps
    from frostnet_tpu_torch.optim import set_warmup

    ref = np.load(GAN_PIX2PIX_REFERENCE)
    net_g, net_d = gan_train_nets("pix2pix")
    trees = numpy_init((net_g, net_d), GAN_TRAIN["seed"], init="gan")
    g_tx, d_tx = gan_optimizers()
    g = make_net_state(net_g, g_tx, 0, dev, trees[0])
    d = make_net_state(net_d, d_tx, 0, dev, trees[1])
    sites = observers(net_g)
    batches = gan_train_batches(4)
    fq = ops.fake_quant_observe
    losses, launches, fp32_state = {k: [] for k in PIX2PIX_LOSSES}, [], None
    for k, mode in enumerate((FP32, QAT, QAT)):
        if k == 1:
            set_warmup(g.optimizer, False)
        d_step, g_step = make_pix2pix_steps(mode)
        before = fq.launches
        kept = [b.clone() for b in net_g.buffers()]
        m = d_step(g, d, batches[k])
        if not all(torch.equal(a, b) for a, b in zip(kept, net_g.buffers())):
            raise AssertionError("pix2pix d_step kept an update of G's BN statistics or "
                                 "observers (hazard 1)")
        m.update(g_step(g, d, batches[k]))
        launches.append(fq.launches - before)
        for key in PIX2PIX_LOSSES:
            losses[key].append(float(m[key]))
        if k == 0:
            fp32_state = {f"fp32/{n}": v for n, v in {**_prefixed("G", net_g, ("batch_stats/",)),
                                                       **_prefixed("D", net_d)}.items()}
    net_g.eval()
    with torch.no_grad():
        out = net_g(torch.as_tensor(batches[3]["A"], device=dev), QAT_FROZEN)
    frozen = out[0, ::GAN_SAMPLE, ::GAN_SAMPLE].cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        if launches != [0, 2 * sites, 2 * sites]:
            raise AssertionError(f"pix2pix iterations: fake_quant_observe launches {launches} "
                                 f"!= [0, {2 * sites}, {2 * sites}]")
    final = {**_prefixed("G", net_g), **_prefixed("D", net_d), **fp32_state}
    rep = {"losses": losses, "launches_per_iteration": launches, "sites": sites}
    rep.update(gan_band_report(ref, losses, fp32_state, final, PIX2PIX_LOSSES, "pix2pix",
                               frozen))
    return rep


def cyclegan_against_reference(dev):
    """Phase 19, part c: CycleGAN from the GAN numpy init at seed 0 against
    the committed JAX reference: one FP32 and one QAT iteration (``g_step``,
    two ``ImagePool.query`` calls, both ``d_step``s), in the bands above,
    the FP32 iteration's fakes within ``GAN_FAKE_ABS``; the generators'
    state after the last iteration is that of their second apply (hazard 4:
    the reference's); on the card, the fake-quant launches of each
    ``g_step`` (0, then six a site)."""
    from frostnet_tpu_torch.gan import ImagePool
    from frostnet_tpu_torch.gan.models import (make_cyclegan_steps, make_joint_optimizer,
                                               make_net_state)
    from frostnet_tpu_torch.optim import set_warmup

    ref = np.load(GAN_CYCLEGAN_REFERENCE)
    nets = gan_train_nets("cycle_gan")
    trees = numpy_init(nets, GAN_TRAIN["seed"], init="gan")
    g_tx, d_tx = gan_optimizers()
    gA, gB = (make_net_state(n, None, 0, dev, t) for n, t in zip(nets[:2], trees[:2]))
    dA, dB = (make_net_state(n, d_tx, 0, dev, t) for n, t in zip(nets[2:], trees[2:]))
    joint = make_joint_optimizer(g_tx, nets[:2])
    pool_a, pool_b = ImagePool(50, 0), ImagePool(50, 1)
    sites = observers(nets[0])
    fq = ops.fake_quant_observe
    losses, launches, fp32_state, fakes = {k: [] for k in CYCLEGAN_LOSSES}, [], None, None
    for k, (batch, mode) in enumerate(zip(gan_train_batches(2), (FP32, QAT))):
        if k == 1:
            set_warmup(joint, False)
        g_step, d_step = make_cyclegan_steps(mode)
        before = fq.launches
        fake_a, fake_b, m = g_step(gA, gB, dA, dB, batch, joint)
        launches.append(fq.launches - before)
        fb, fa = fake_b.cpu().numpy(), fake_a.cpu().numpy()
        m["loss_D_A"] = d_step(dA, batch["B"], pool_b.query(fb))
        m["loss_D_B"] = d_step(dB, batch["A"], pool_a.query(fa))
        for key in CYCLEGAN_LOSSES:
            losses[key].append(float(m[key]))
        if k == 0:
            fp32_state = {f"fp32/{n}": v for n, v in {
                **_prefixed("G_A", nets[0], ("batch_stats/",)),
                **_prefixed("G_B", nets[1], ("batch_stats/",))}.items()}
            fakes = (fa[0, ::GAN_SAMPLE, ::GAN_SAMPLE], fb[0, ::GAN_SAMPLE, ::GAN_SAMPLE])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        if launches != [0, 6 * sites]:
            raise AssertionError(f"CycleGAN g_step: fake_quant_observe launches {launches} != "
                                 f"[0, {6 * sites}]")
    fake_err = max(float(np.abs(fakes[0] - ref["fake_a_sampled"]).max()),
                   float(np.abs(fakes[1] - ref["fake_b_sampled"]).max()))
    band_check("CycleGAN FP32 iteration fakes, max |diff|", fake_err, GAN_FAKE_ABS)
    final = {**_prefixed("G_A", nets[0]), **_prefixed("G_B", nets[1]), **fp32_state}
    rep = {"losses": losses, "launches_per_g_step": launches, "sites": sites,
           "fake_abs": fake_err}
    rep.update(gan_band_report(ref, losses, fp32_state, final, CYCLEGAN_LOSSES, "CycleGAN"))
    return rep


def check_gan_fake_quant(dev):
    """Phase 19, part a: the fake-quant kernel against its plain version, bit
    for bit, at every per-tensor site of a ``resnet_9blocks`` QAT forward at
    256x256 (the GAN numpy init, train mode), batch 1 and 4, float32: y, the
    STE mask, the new observers and the qparams, then the QAT_FROZEN pass;
    the STE gradient of the largest site. Returns (checks, max error, the
    batch-1 sites for timing)."""
    net = gan_train_nets("pix2pix")[0]
    from_jax_variables(net, numpy_init(net, 0, init="gan")).to(dev)
    err, checked, keep = 0.0, 0, None
    for batch in (1, 4):
        x = torch.as_tensor(gan_train_batches(1, batch)[0]["A"], device=dev)
        sites = capture_sites(net, x, QAT)
        if len(sites) != GAN_SITES:
            raise AssertionError(f"GAN: {len(sites)} per-tensor sites in a QAT forward, "
                                 f"expected {GAN_SITES}")
        for i, (xs, mn, mx, spec) in enumerate(sites):
            err = max(err, check_site(f"GAN batch {batch} site {i} {tuple(xs.shape)}", xs, mn,
                                      mx, spec))
            checked += 1
        keep = keep or sites
    xs, mn, mx, spec = max(sites, key=lambda s: s[0].numel())
    obs = Observer().to(dev)
    obs.min_val.copy_(mn)
    obs.max_val.copy_(mx)
    xg = xs.clone().requires_grad_(True)
    g = torch.randn(xs.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    ObservedFakeQuant.apply(xg, obs, spec, True).backward(g)
    _, pmask, _, _, _ = fake_quant_observe_plain(xs, ObserverState(mn, mx), spec, True)
    if not torch.equal(xg.grad, torch.where(pmask, g, torch.zeros((), device=dev))):
        raise AssertionError("GAN: fake_quant_observe STE gradient != where(plain mask, g, 0)")
    torch.cuda.synchronize()
    return checked, err, tuple(xs.shape), keep


GAN_TRAINER_CFG = dict(model="pix2pix", netG=GAN, dataset="synthetic", crop_size=GAN_IMAGE,
                       batch_size=1, steps_per_epoch=2, fp_epochs=1, save_epoch_freq=1,
                       device="cuda")


def gan_trainer_path(dev):
    """Phase 19, part d: ``gan.train.main`` (pix2pix, synthetic, 256x256,
    batch 1, 2 steps an epoch, one FP32 epoch and one QAT epoch), its
    ``--continue_train`` to a second QAT epoch against an uninterrupted run
    of two (losses bit for bit), ``gan.test.main --checkpoint latest_G
    --export_int8`` (the gallery and the artifact), ``serve.main --workload
    gan`` on that artifact against the in-process ``freeze`` of the restored
    generator (bit for bit; 20 conv and 3 matmul launches a forward), and
    ``eval_cityscapes.score_pairs`` on the tester's outputs with the port's
    ``mobilenetv3_RE_small`` (the committed calibration), checked against
    ``fast_hist`` on the host. Returns (report, launches of the path)."""
    from frostnet_tpu_torch.gan import eval_cityscapes, test as gan_test, train as gan_train
    from frostnet_tpu_torch.gan.models import make_net_state
    from frostnet_tpu_torch.gan.networks import define_g
    from frostnet_tpu_torch.segmentation import get_seg_model
    from frostnet_tpu_torch.utils.checkpoint import restore_model_variables

    rep = {}
    shutil.rmtree(PHASE19_DIR, ignore_errors=True)
    split, whole = os.path.join(PHASE19_DIR, "split"), os.path.join(PHASE19_DIR, "whole")
    # the runs compared bit for bit take cuDNN's and torch's deterministic
    # algorithms (the resize's index_select backward adds with atomics otherwise)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, first = gan_train.main(gan_train.GANConfig(**GAN_TRAINER_CFG, epochs=1,
                                                         save_dir=split))
        _, _, resumed = gan_train.main(gan_train.GANConfig(**GAN_TRAINER_CFG, epochs=2,
                                                           save_dir=split, continue_train=True))
        rep["train_s"] = time.perf_counter() - t0
        launches = ops.launch_counts()
        _, _, straight = gan_train.main(gan_train.GANConfig(**GAN_TRAINER_CFG, epochs=2,
                                                            save_dir=whole))
    finally:
        torch.use_deterministic_algorithms(False)
    got = [h["losses"] for h in first["history"] + resumed["history"]]
    want = [h["losses"] for h in straight["history"]]
    if got != want or [h["tag"] for h in resumed["history"]] != ["qat"]:
        raise AssertionError(f"pix2pix resume: losses {got} != uninterrupted {want}")
    for h in straight["history"]:
        if not all(np.isfinite(v).all() for v in h["losses"].values()):
            raise AssertionError(f"pix2pix trainer: {h['tag']} epoch {h['epoch']} {h['losses']}")
    rep["history"] = [{k: h[k] for k in ("tag", "epoch", "losses", "images_per_sec", "step_ms")}
                      for h in straight["history"]]
    log(f"[gan-train] gan.train.main pix2pix: epochs {[(h['tag'], h['last']) for h in straight['history']]}; "
        f"the resume to a second QAT epoch == the uninterrupted run, bit for bit")
    ckpt = os.path.join(split, "latest_G")
    art = os.path.join(PHASE19_DIR, "netG_int8.npz")
    results = os.path.join(PHASE19_DIR, "results")
    ops.reset_launch_counts()
    out = gan_test.main(gan_test.build_parser().parse_args(
        ["--checkpoint", ckpt, "--netG", GAN, "--num_test", "2", "--results_dir", results,
         "--export_int8", art]))
    torch.cuda.synchronize()
    tester = ops.launch_counts()
    pngs = sorted(os.listdir(os.path.join(results, "web", "images")))
    if not os.path.exists(out["gallery"]) or len(pngs) != 8:
        raise AssertionError(f"gan.test.main: gallery {out['gallery']}, images {pngs}")
    if tester["int8_conv"] != 2 * 20 or tester["int8_matmul_requant"] != 2 * 3:
        raise AssertionError(f"gan.test.main launches {tester} (two INT8 forwards)")
    rep["tester"] = {"delta": out["delta"], "artifact_bytes": out["artifact_bytes"],
                     "launches": tester}
    log(f"[gan-train] gan.test.main: qat/int8 delta {out['delta']}, artifact "
        f"{out['artifact_bytes']} bytes, gallery {len(pngs)} PNGs, launches {tester}")
    served = os.path.join(PHASE19_DIR, "served.npy")
    serve.main(serve.build_parser().parse_args(
        ["--workload", "gan", "--artifact", art, "--batch_size", "2", "--iters", "3",
         "--save_logits", served]))
    net = define_g(netG=GAN)
    restore_model_variables(ckpt, make_net_state(net, None, 0, dev))
    fn = freeze(net, dev, GAN_IMAGE)
    x = np.random.RandomState(0).randn(2, GAN_IMAGE, GAN_IMAGE, 3).astype(np.float32)
    ops.reset_launch_counts()
    want = fn(x)
    torch.cuda.synchronize()
    per_forward = ops.launch_counts()
    if not np.array_equal(np.load(served), want.cpu().numpy()):
        raise AssertionError("serve.main --workload gan on the trained artifact != the "
                             "in-process freeze of the restored generator")
    if per_forward != GAN_LAUNCHES:
        raise AssertionError(f"trained generator: launches per forward {per_forward}")
    rep["served_launches_per_forward"] = per_forward
    log(f"[gan-train] serve.main --workload gan on the trained artifact == in-process freeze, "
        f"bit for bit; launches a forward {per_forward}")
    seg = get_seg_model("mobilenetv3_RE_small", num_classes=SEG_CLASSES)
    from_jax_variables(seg, unflatten_variables(seg_variables("mobilenetv3_RE_small")))
    seg.to(dev).eval()
    predict = eval_cityscapes.make_seg_predict_fn(seg, QAT_FROZEN, (0.485, 0.456, 0.406),
                                                  (0.229, 0.224, 0.225))
    rng = np.random.RandomState(19)
    pairs = [((o[0] + 1) / 2, rng.randint(0, SEG_CLASSES, (GAN_IMAGE, GAN_IMAGE)))
             for o in out["int8"]]
    scores = eval_cityscapes.score_pairs(predict, pairs, SEG_CLASSES)
    hist = sum(eval_cityscapes.fast_hist(lab.flatten(), predict(img).flatten(), SEG_CLASSES)
               for img, lab in pairs)
    if not np.array_equal(scores["hist"], hist) or hist.sum() != 2 * GAN_IMAGE ** 2:
        raise AssertionError("eval_cityscapes.score_pairs != fast_hist on the host")
    rep["fcn_scores"] = {k: scores[k] for k in ("frames", "mean_pixel_acc", "mean_class_acc",
                                                "mean_class_iou")}
    log(f"[gan-train] eval_cityscapes.score_pairs on the tester's 2 INT8 outputs "
        f"(mobilenetv3_RE_small, QAT_FROZEN): {rep['fcn_scores']}; == fast_hist on the host")
    return rep, launches


def _pix2pix_iteration(dev, mode, batch, g=None, d=None):
    """(run one iteration, states) of pix2pix at ``batch`` from the GAN init."""
    from frostnet_tpu_torch.gan.models import make_net_state, make_pix2pix_steps
    from frostnet_tpu_torch.optim import set_warmup

    if g is None:
        net_g, net_d = gan_train_nets("pix2pix")
        trees = numpy_init((net_g, net_d), 0, init="gan")
        g_tx, d_tx = (get_optimizer("QAdam", GAN_TRAIN["lr"], b1=GAN_TRAIN["beta1"]),
                      get_optimizer("Adam", GAN_TRAIN["lr"], b1=GAN_TRAIN["beta1"]))
        g = make_net_state(net_g, g_tx, 0, dev, trees[0])
        d = make_net_state(net_d, d_tx, 0, dev, trees[1])
    if mode is QAT:
        set_warmup(g.optimizer, False)  # the GradBoost noise on
    d_step, g_step = make_pix2pix_steps(mode)
    b = {k: torch.as_tensor(v, device=dev) for k, v in gan_train_batches(1, batch)[0].items()}

    def run():
        d_step(g, d, b)
        g_step(g, d, b)

    return run, g, d


# name fragments of cuDNN's convolution kernels (forward, data and weight
# gradients, its layout transforms, and the cuFFT and complex cuBLAS gemv
# kernels of its FFT algorithms: the iteration has no other matmul or FFT);
# cuDNN's BN kernels stay with the torch ops
CUDNN_CONV = ("cudnn", "xmma", "cutlass", "implicit", "convolve", "conv2d", "wgrad", "dgrad",
              "fprop", "fft", "gemv")
CUDNN_BN = ("bn_", "batch_norm", "batchnorm")
GAN_TRAIN_KERNELS = {
    "fake_quant_observe": "fq_",
    "cuDNN convs": lambda name: (any(f in name.lower() for f in CUDNN_CONV)
                                 and not any(f in name.lower() for f in CUDNN_BN))}


def time_gan_training(dev, sites):
    """Phase 19, part e: float32 (TF32 off) pix2pix FP32 and QAT iterations
    at batch 1 and 8 and the CycleGAN QAT iteration at batch 1 (the GradBoost
    noise on), ms and images/s, peak memory; the fake-quant kernel at the
    batch-1 forward's sites beside its bound, plain version and library
    call (CUDA graph and wall time); one profiled pix2pix QAT iteration at
    batch 1."""
    from frostnet_tpu_torch.gan import ImagePool
    from frostnet_tpu_torch.gan.models import (make_cyclegan_steps, make_joint_optimizer,
                                               make_net_state)
    from frostnet_tpu_torch.optim import set_warmup

    rec = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in (1, 8):
        run, g, d = _pix2pix_iteration(dev, FP32, batch)
        rec[f"pix2pix_fp32_bs{batch}_ms"] = ms = time_ms(run, reps=5, warmup=1)
        rec[f"pix2pix_fp32_bs{batch}_images_per_sec"] = batch / ms * 1e3
        run, _, _ = _pix2pix_iteration(dev, QAT, batch, g, d)
        rec[f"pix2pix_qat_bs{batch}_ms"] = ms = time_ms(run, reps=5, warmup=1)
        rec[f"pix2pix_qat_bs{batch}_images_per_sec"] = batch / ms * 1e3
        log(f"[time] pix2pix iteration at batch {batch} (float32, TF32 off): FP32 "
            f"{rec[f'pix2pix_fp32_bs{batch}_ms']:.2f} ms, "
            f"{rec[f'pix2pix_fp32_bs{batch}_images_per_sec']:.2f} images/s; QAT "
            f"{rec[f'pix2pix_qat_bs{batch}_ms']:.2f} ms, "
            f"{rec[f'pix2pix_qat_bs{batch}_images_per_sec']:.2f} images/s")
        if batch == 1:
            rec["profile"] = profile_forward(lambda _: run(), None, GAN_TRAIN_KERNELS)
            log_profile("pix2pix QAT iteration at batch 1", rec["profile"])
        del run, g, d
    nets = gan_train_nets("cycle_gan")
    trees = numpy_init(nets, 0, init="gan")
    gA, gB = (make_net_state(n, None, 0, dev, t) for n, t in zip(nets[:2], trees[:2]))
    dA, dB = (make_net_state(n, get_optimizer("Adam", 2e-4, b1=0.5), 0, dev, t)
              for n, t in zip(nets[2:], trees[2:]))
    joint = make_joint_optimizer(get_optimizer("QAdam", 2e-4, b1=0.5), nets[:2])
    set_warmup(joint, False)
    g_step, d_step = make_cyclegan_steps(QAT)
    pool_a, pool_b = ImagePool(50, 0), ImagePool(50, 1)
    b = {k: torch.as_tensor(v, device=dev) for k, v in gan_train_batches(1)[0].items()}

    def cycle():
        fake_a, fake_b, _ = g_step(gA, gB, dA, dB, b, joint)
        d_step(dA, b["B"], pool_b.query(fake_b.cpu().numpy()))
        d_step(dB, b["A"], pool_a.query(fake_a.cpu().numpy()))

    rec["cyclegan_qat_bs1_ms"] = ms = time_ms(cycle, reps=3, warmup=1)
    rec["cyclegan_qat_bs1_images_per_sec"] = 1e3 / ms
    rec["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[time] CycleGAN QAT iteration at batch 1: {ms:.2f} ms, {1e3 / ms:.2f} images/s; "
        f"peak memory over the timed GAN iterations {rec['max_memory_allocated_gib']:.2f} GiB")
    del gA, gB, dA, dB, joint, nets
    torch.cuda.empty_cache()
    rec["fake_quant"] = time_gan_sites(sites)
    return rec


def time_gan_sites(sites):
    """The fake-quant kernel at the sites of one QAT forward, without the
    profiler (late in this process it records nothing): device time by a
    replayed CUDA graph of all the sites, wall time of back-to-back calls,
    the bound; the plain version and ``torch.fused_moving_avg_obs_fake_quant``
    (float32 copies, the yardstick only), wall. The observer states are
    copies."""
    states = [(mn.clone(), mx.clone()) for _, mn, mx, _ in sites]

    def kernel():
        for (x, _, _, spec), (mn, mx) in zip(sites, states):
            fake_quant_observe(x, mn, mx, spec)

    def plain():
        for x, mn, mx, spec in sites:
            fake_quant_observe_plain(x, ObserverState(mn, mx), spec)

    library = fq_library_call(sites)
    nbytes = sum(fq_cost(x)[0] for x, _, _, _ in sites)
    nops = sum(fq_cost(x)[1] for x, _, _, _ in sites)
    bound_ms, bound_by = bound(nbytes, nops, PEAK_F32_OPS_PER_S)
    out = {"sites": len(sites), "graph_ms": graph_ms(kernel, reps=3),
           "wall_ms": time_ms(kernel, reps=5), "plain_ms": time_ms(plain, reps=1, warmup=1),
           "library_wall_ms": time_ms(library, reps=5), "bound_ms": bound_ms,
           "bound_by": bound_by}
    out["bound_share"] = bound_ms / out["graph_ms"]
    log(f"[time] fake_quant_observe at the {len(sites)} sites of a batch-1 generator QAT "
        f"forward: {out['graph_ms']:.4f} ms by CUDA graph ({100 * out['bound_share']:.1f}% of the "
        f"{bound_ms:.4f} ms bound), {out['wall_ms']:.4f} wall; plain {out['plain_ms']:.3f}; "
        f"torch.fused_moving_avg_obs_fake_quant {out['library_wall_ms']:.4f} wall")
    return out


def gan_train_phase(dev):
    """Phase 19: GAN training on the card (the fake-quant kernel at the
    generator's QAT sites, pix2pix and CycleGAN against the committed JAX
    references, the trainer -> tester -> server -> scorer path, times).
    Returns (report, launches of each path)."""
    rep, launches = {}, {}
    os.makedirs(PHASE19_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checked, rep["fake_quant_max_abs_err"], largest, sites = check_gan_fake_quant(dev)
    log(f"[gan-train] fake_quant_observe == plain at {checked} site checks (the {GAN_SITES} "
        f"sites of a resnet_9blocks QAT forward at {GAN_IMAGE}x{GAN_IMAGE}, batch 1 and 4, "
        f"float32; QAT and QAT_FROZEN passes), STE gradient at {largest}")
    ops.reset_launch_counts()
    rep["pix2pix_reference"] = pix2pix_against_reference(dev)
    launches["pix2pix_reference"] = ops.launch_counts()
    ops.reset_launch_counts()
    rep["cyclegan_reference"] = cyclegan_against_reference(dev)
    launches["cyclegan_reference"] = ops.launch_counts()
    torch.cuda.empty_cache()
    rep["trainer"], launches["trainer"] = gan_trainer_path(dev)
    for path in ("pix2pix_reference", "cyclegan_reference", "trainer"):
        if launches[path]["fake_quant_observe"] == 0:
            raise AssertionError(f"phase 19's {path} path launched no fake_quant_observe")
    launches["tester_and_server"] = rep["trainer"]["tester"]["launches"]
    torch.cuda.empty_cache()
    rep["timing"] = time_gan_training(dev, sites)
    del sites
    torch.cuda.empty_cache()
    return rep, launches


# ---------------------------------------------------------------------------
# Phase 20: the rest of the zoo (VGG, ShuffleNetV2, AlexNet, ESPNetv2, ESPNet,
# the ESPNetv2 classifier, the float-only baselines)
# ---------------------------------------------------------------------------

PHASE20_DIR = os.path.join(ROOT, "build", "phase20")
ZOO_CLS = ("qvgg16_bn", "qshufflenet_v2_x1_0", "qalexnet")
# the segmentation fixtures (tests/test_torch_zoo_fixture.py): 19 classes, 768x768
ZOO_SEG = {"espnetv2": {"s": 2.0}, "espnet": {"p": 2, "q": 8}}
ZOO_SEG_BATCH = 2
ZOO_FLOAT = (("densenet121", 224), ("squeezenet1_1", 224), ("mnasnet1_0", 224),
             ("inception_v3", 299))
ZOO_SEG_TRAINER_CFG = dict(model="espnetv2", width_scale=2.0, dataset="synthetic",
                           crop_size=SEG_CROP, batch_size=4, steps_per_epoch=1, fp_epochs=1,
                           epochs=1, seed=0)
# the dense conv kernel's shapes whose channel counts are not multiples of 4:
# (what, conv, B, H, W, Cin, Cout); the others come from the served forwards
ODD_CONV_RANDOM = (("espnet decoder conv, 20 classes", 2, 384, 384, 39, 20),)


def zoo_model(name: str):
    """A fixture's port model (the segmentation ones with 19 classes)."""
    from frostnet_tpu_torch.segmentation import get_seg_model

    if name in ZOO_SEG:
        return get_seg_model(name, num_classes=SEG_CLASSES, **ZOO_SEG[name])
    return create_model(name)


def zoo_variables(name: str) -> dict:
    """``numpy_init(model, 0)`` with the committed calibration on top
    (``tests/test_torch_zoo_fixture.py`` makes it), flat."""
    flat = flatten_variables(numpy_init(zoo_model(name), 0))
    with np.load(os.path.join(TESTDATA, f"zoo_{name}_calibration.npz")) as cal:
        for k in cal.files:
            if k not in flat or flat[k].shape != cal[k].shape:
                raise AssertionError(f"{name} calibration: {k} does not fit the model")
            flat[k] = cal[k]
    return flat


def zoo_artifact(name: str, path: str) -> str:
    export_int8(from_jax_variables(zoo_model(name), unflatten_variables(zoo_variables(name))),
                path)
    return path


def zoo_predictor(name: str, device, artifact_dir=None) -> Int8Predictor:
    """``Int8Predictor`` over a classification fixture, served from the
    port's own ``export_int8`` of it."""
    with tempfile.TemporaryDirectory() as tmp:
        root = artifact_dir or tmp
        os.makedirs(root, exist_ok=True)
        artifact = zoo_artifact(name, os.path.join(root, f"zoo_{name}_int8.npz"))
        return Int8Predictor(name, artifact=artifact, image_size=IMAGE, device=device)


def module_codes(model, fn, images):
    """(output, {module path: codes}) of one call: the QTensor output of
    every module, by its path (``/``-joined, the JAX module paths). The
    hooks only keep references."""
    codes, hooks = {}, []
    for name, mod in model.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, key="/".join(name.split(".")): codes.__setitem__(key, out.q)
                if isinstance(out, QTensor) else None))
    try:
        out = fn(images)
    finally:
        for h in hooks:
            h.remove()
    return out, codes


def check_digests(what, codes, ref):
    """Every layer of the reference, per image, equal to its digest."""
    layers = [k[len("sha256/"):] for k in ref.files if k.startswith("sha256/")]
    bad = []
    for layer in layers:
        got = codes.get(layer)
        if got is None or tuple(got.shape[1:]) != tuple(ref[f"shape/{layer}"][1:]):
            bad.append(f"{layer} (shape {None if got is None else tuple(got.shape)})")
            continue
        want = list(ref[f"sha256/{layer}"])
        digests = code_digests(got)
        if digests != want[:len(digests)]:
            bad.append(f"{layer} (images {[i for i, (g, w) in enumerate(zip(digests, want)) if g != w]})")
    if bad:
        raise AssertionError(f"{what}: codes differ from the JAX reference at {len(bad)} layers: "
                             + ", ".join(bad[:8]))
    return layers


def route_counts(model):
    """The kernel launches of one INT8 forward, from the convs' routes."""
    convs = [m for m in model.modules() if isinstance(m, QConvBNAct) and hasattr(m, "_route")]
    return {"int8_matmul_requant": sum(m._route in ("matmul", "im2col") for m in convs),
            "frost_block_int8": 0, "fake_quant_observe": 0,
            "int8_conv": sum(m._route == "dense3x3" for m in convs),
            "depthwise_int8": sum(m._route == "depthwise" for m in convs),
            "resize_bilinear": resize_sites(model)}


def resize_sites(model) -> int:
    """The resizes of one forward of ``model`` on the card, one launch each
    with or without a gradient (``ops/resize.py``): a MobileNet segmenter's
    LR-ASPP gate and head and its tail, the pooled ASPP branch and the
    R-ASPP head's c4 to c1, the GAN generator's two 2x upsamplings,
    Tiny-DSOD's five ``requant_up`` joins, each stage of a PSP module,
    ESPNetv2's three ``_up`` steps and its tail, ESPNet's two and its tail.
    The modules that call ``ops.resize`` are these alone."""
    from frostnet_tpu_torch.detection.tdsod import TDSODFeat
    from frostnet_tpu_torch.gan.networks import ResnetGenerator
    from frostnet_tpu_torch.segmentation.espnet import ESPNetSeg, ESPNetv2Seg, PSPModule
    from frostnet_tpu_torch.segmentation.heads import ASPPPooling, LRASPP, LRASPPHead, RASPPHead
    from frostnet_tpu_torch.segmentation.models import _SegModel

    per = ((LRASPP, 1), (LRASPPHead, 1), (ASPPPooling, 1), (RASPPHead, 1), (_SegModel, 1),
           (ResnetGenerator, 2), (TDSODFeat, 5), (ESPNetv2Seg, 4), (ESPNetSeg, 3))
    return sum(n for m in model.modules() for cls, n in per if isinstance(m, cls)) + \
        sum(len(m.stages) for m in model.modules() if isinstance(m, PSPModule))


def serve_zoo_classifiers(dev):
    """Phase 20, part a: each classification fixture served at batch 8
    through ``Int8Predictor`` from the port's export: every layer's codes
    against the JAX digests, the logits within one step of the last
    ``QDense``'s output grid, one forward's launches as its routes say;
    ``serve.main --workload cls`` on the artifact equal to the predictor bit
    for bit; the dense conv and the matmul kernels against their plain
    versions at every call of the forward."""
    images = np.random.RandomState(0).randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    x = torch.as_tensor(images, device=dev)
    out, err, launches, odd = {}, {"int8_conv": 0, "int8_matmul_requant": 0}, {}, []
    for name in ZOO_CLS:
        ref = np.load(os.path.join(TESTDATA, f"zoo_{name}_reference.npz"))
        pred = zoo_predictor(name, dev, PHASE20_DIR)
        expect = route_counts(pred.model)
        ops.reset_launch_counts()
        logits, codes = layer_codes(pred, images)
        torch.cuda.synchronize()
        launches[f"serving {name}"] = counts = ops.launch_counts()
        if counts != expect:
            raise AssertionError(f"{name}: launches per forward {counts} != {expect}")
        layers = check_digests(name, codes, ref)
        got = logits.cpu().numpy()
        want = ref["logits"][:got.shape[0]]
        last = [m for m in pred.model.modules() if type(m).__name__ == "QDense"][-1]
        step = float(last._out_t[0])
        diff = float(np.abs(got - want).max())
        if got.shape != want.shape or not np.isfinite(got).all() or diff > step * 1.0001:
            raise AssertionError(f"{name}: logits {diff} from JAX's (grid step {step})")
        saved = os.path.join(PHASE20_DIR, f"{name}_logits.npy")
        rep = serve.main(serve.build_parser().parse_args(
            ["--workload", "cls", "--model", name, "--artifact",
             os.path.join(PHASE20_DIR, f"zoo_{name}_int8.npz"), "--iters", "5", "--batch_size",
             str(BATCH), "--save_logits", saved]))
        # serve.main's first request batch is these images (RandomState(0))
        if not np.array_equal(np.load(saved), got):
            raise AssertionError(f"{name}: serve.main logits != the predictor's")
        convs = [(c, m, inp.q) for c, m, inp in capture(pred.model, x)
                 if getattr(m, "_route", None) == "dense3x3"]
        e, n_conv = check_conv_calls(name, convs, dev)
        err["int8_conv"] = max(err["int8_conv"], e)
        odd += [(f"{name} {c}", m._op, q) for c, m, q in convs if m.in_features % 4]
        e, shapes = check_mobilenet_matmuls(name, pred, x, dev)
        err["int8_matmul_requant"] = max(err["int8_matmul_requant"], e)
        out[name] = {"launches": counts, "layers": len(layers), "logits_max_diff": diff,
                     "logits_step": step, "logits_equal": bool(np.array_equal(got, want)),
                     "conv_checks": n_conv, "matmul_shapes": shapes,
                     "serve_main": {k: rep[k] for k in ("latency_ms", "request_images_per_sec",
                                                        "pipeline_images_per_sec")}}
        log(f"[zoo] {name} served at batch {BATCH}: launches per forward {counts}; codes == JAX "
            f"reference at {len(layers)} layers x {BATCH} images; logits {diff:.3g} from JAX's "
            f"(grid step {step:.4g}, equal: {out[name]['logits_equal']}); serve.main == "
            f"predictor; int8_conv == plain at {n_conv} checks, matmul == plain at "
            f"{len(shapes)} shapes (aligned and unaligned rows)")
        if name == "qvgg16_bn":
            out[name]["conv_rows"] = time_vgg_convs(pred, x)
        del pred
        torch.cuda.empty_cache()
    return out, err, launches, odd


def time_vgg_convs(pred, x):
    """Phase 20, part b: the dense conv kernel at each distinct conv shape
    of qvgg16_bn at batch 8, beside its bound, its plain version and
    ``torch._int_mm`` on the im2col operand."""
    rows, seen = [], set()
    for name, mod, inp in capture(pred.model, x):
        q = inp.q
        if mod._route != "dense3x3" or tuple(q.shape) in seen:
            continue
        seen.add(tuple(q.shape))
        rows.append(conv_row(f"qvgg16_bn {name}", mod._op, q))
    return rows


def conv_row(what, op, q):
    """One timing row of the dense conv at ``q``; ``torch._int_mm`` on the
    im2col operand, its weight rows padded with zeros to a multiple of 8
    where Cout is not one (``_int_mm`` refuses such an N)."""
    a = matmul_operand_conv(op, q)
    wt = torch.nn.functional.pad(op.weight().permute(0, 2, 3, 1).reshape(op.cout, -1),
                                 (0, a.shape[1] - 9 * op.cin, 0, -op.cout % 8))
    lib = int_mm_ms(a, wt, reps=10)
    del a
    b, h, w, cin = q.shape
    row = kernel_row(f"{what} {b}x{h}x{w}x{cin}->{op.cout}", lambda: conv3x3_s1_int8(q, op),
                     lambda: conv3x3_s1_int8_plain(q, op), conv3x3_cost(tuple(q.shape), op.cout),
                     lib, reps=20, plain_reps=1)
    row["path"] = "zoo"
    log(f"[time] int8_conv {row['shape']}: {row_text(row)}")
    return row


def matmul_operand_conv(op, q):
    """The im2col operand of a dense 3x3 conv ('same' padding with the zero
    point, rows padded to 16 bytes): what ``torch._int_mm`` would multiply."""
    p = torch.nn.functional.pad(q, (0, 0, 1, 1, 1, 1), value=op.zp_in)
    h, w = q.shape[1], q.shape[2]
    cols = [p[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    pad = -(9 * q.shape[3]) % 16
    if pad:
        cols.append(q.new_zeros(q.shape[0], h, w, pad))
    return torch.cat(cols, dim=-1).reshape(-1, 9 * q.shape[3] + pad)


def serve_zoo_segs(dev):
    """Phase 20, part c: each segmentation fixture at 768x768 (batch 2),
    from the port's export, read back and frozen: every module's codes
    against the JAX digests, the sampled logits and the argmax in phase 17's
    bands, one forward's launches as its routes say; the ``grouped`` route's
    time (ESPNetv2's grouped 1x1s, float64 torch convs) beside the
    forward's."""
    from frostnet_tpu_torch.quant import load_int8

    images = seg_images(0, ZOO_SEG_BATCH)
    out, launches, odd, served = {}, {}, [], {}
    for name in ZOO_SEG:
        ref = np.load(os.path.join(TESTDATA, f"zoo_{name}_reference.npz"))
        artifact = zoo_artifact(name, os.path.join(PHASE20_DIR, f"zoo_{name}_int8.npz"))
        model = from_jax_variables(zoo_model(name), load_int8(artifact))
        fn = freeze(model, dev)
        expect = route_counts(model)
        ops.reset_launch_counts()
        logits, codes = module_codes(model, fn, images)
        torch.cuda.synchronize()
        launches[f"serving {name}"] = counts = ops.launch_counts()
        if counts != expect:
            raise AssertionError(f"{name}: launches per forward {counts} != {expect}")
        layers = check_digests(name, codes, ref)
        rec = {"launches": counts, "layers": len(layers),
               **seg_logits_check(name, logits, ref)}
        x = torch.as_tensor(images, device=dev)
        rec["forward_ms"] = time_ms(lambda: fn(x), reps=5, warmup=1)
        grouped = [(c, m, inp) for c, m, inp in capture(model, x) if getattr(m, "_route", None) == "grouped"]
        rec["grouped_ms"] = sum(time_ms(lambda m=m, inp=inp: m(inp, mode=INT8), reps=3,
                                        warmup=1) for _, m, inp in grouped)
        rec["grouped_convs"] = len(grouped)
        odd += [(f"{name} {c}", m._op, inp.q) for c, m, inp in capture(model, x)
                if getattr(m, "_route", None) == "dense3x3"
                and (m.in_features % 4 or m.features % 4)]
        try:
            rec["profile"] = profile_forward(fn, x, {"int8_matmul_requant": "matmul",
                                                     "int8_conv": "conv3x3_s1_int8",
                                                     "depthwise_int8": "depthwise_int8_kernel"})
            log_profile(f"{name} INT8 forward at {SEG_CROP}x{SEG_CROP}, batch {ZOO_SEG_BATCH}",
                        rec["profile"])
        except RuntimeError as e:
            log(f"[zoo] {name}: no profile ({e})")
            rec["profile"] = None
        out[name] = rec
        served[name] = (model, fn)
        log(f"[zoo] {name} served at {SEG_CROP}x{SEG_CROP}, batch {ZOO_SEG_BATCH}: launches per "
            f"forward {counts}; codes == JAX reference at {len(layers)} module outputs x "
            f"{ZOO_SEG_BATCH} images; sampled logits / argmax per image: "
            + ", ".join(f"{r['logits_max_diff']:.3g} / {r['argmax_mismatch_share']:.3g}"
                        for r in rec["images"])
            + f"; forward {rec['forward_ms']:.3f} ms, of which the {len(grouped)} grouped convs "
            f"(float64 torch) {rec['grouped_ms']:.3f} ms")
    return out, launches, odd, served


def check_odd_convs(odd, dev):
    """Phase 20, part d: the dense conv kernel, bit-exact to its plain
    version, at the served forwards' convs whose channel counts are not
    multiples of 4 (3 -> 64, 3 -> 3, 38 -> 19) and at 39 -> 20 (random
    codes), each also with its input one byte into its storage; then timed
    beside its bound, its plain version and ``torch._int_mm``."""
    err, rows, shapes = 0, [], set()
    g = torch.Generator().manual_seed(7)
    cases = list(odd)
    for what, b, h, w, cin, cout in ODD_CONV_RANDOM:
        x = torch.randint(0, 256, (b, h, w, cin), generator=g, dtype=torch.uint8).to(dev)
        qw = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
        op = conv3x3_operands(qw, torch.tensor(4e-5), torch.randn(cout, generator=g) * 0.1, 97,
                              0.05, 11, True, 0, 255, dev)
        cases.append((what, op, x))
    for what, op, x in cases:
        want = conv3x3_s1_int8_plain(x, op)
        err = max(err, check_equal(f"int8_conv {what}", conv3x3_s1_int8(x, op), want))
        buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)
        shifted = buf[1:].view(x.shape)
        shifted.copy_(x)
        err = max(err, check_equal(f"int8_conv {what} (unaligned)", conv3x3_s1_int8(shifted, op),
                                   want))
        key = (tuple(x.shape), op.cout)
        if key not in shapes:
            shapes.add(key)
            rows.append(conv_row(what, op, x))
        del buf, shifted, want
    torch.cuda.synchronize()
    want = {(3, 64), (3, 3), (38, 19), (39, 20)}
    got = {(s[0][3], s[1]) for s in shapes}
    if not want <= got:
        raise AssertionError(f"odd conv shapes {sorted(got)} miss {sorted(want - got)}")
    return err, rows


def train_zoo_classifiers(dev):
    """Phase 20, part e: one QAT step of each classification fixture's model
    (224x224, batch 8, from ``numpy_init``), of ``espnetv2_s_2_0`` with a
    QAT_FROZEN eval forward, and one FP32 step of each float-only baseline:
    finite losses, the fake-quant launches one a site (none for the float
    models)."""
    rep, launches = {}, {}
    for name in ZOO_CLS + ("espnetv2_s_2_0",):
        model = create_model(name, num_classes=CLASSES)
        n_sites = observers(model)
        state = create_train_state(model, get_optimizer("QSGD", 1e-3), seed=0, device=dev)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in train_batch(0).items()}
        state.start_qat()
        ops.reset_launch_counts()
        m = make_train_step(QAT, num_classes=CLASSES)(state, batch)
        rec = {"qat_loss": float(m["loss"])}
        if name.startswith("espnetv2"):
            ev = make_eval_step(QAT_FROZEN, CLASSES)(state, batch)
            rec["qat_frozen_loss"] = float(ev["loss"])
        torch.cuda.synchronize()
        launches[f"qat step {name}"] = counts = ops.launch_counts()
        steps = 2 if name.startswith("espnetv2") else 1
        # the ESPNetv2 classifier's level5_0 observes its zeros reinforcement too
        if counts["fake_quant_observe"] != steps * n_sites or \
                not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"{name}: QAT step {rec}, launches {counts} (sites {n_sites})")
        rep[name] = {**rec, "sites": n_sites, "launches": counts}
        del state, model
        torch.cuda.empty_cache()
    for name, size in ZOO_FLOAT:
        model = create_model(name, num_classes=CLASSES)
        state = create_train_state(model, get_optimizer("SGD", 1e-2), seed=0, device=dev)
        rng = np.random.RandomState(3)
        batch = {"image": torch.as_tensor(rng.randint(0, 256, (BATCH, size, size, 3))
                                          .astype(np.uint8), device=dev),
                 "label": torch.as_tensor(rng.randint(0, CLASSES, BATCH), device=dev)}
        ops.reset_launch_counts()
        m = make_train_step(FP32, num_classes=CLASSES)(state, batch)
        torch.cuda.synchronize()
        launches[f"fp32 step {name}"] = counts = ops.launch_counts()
        if any(counts.values()) or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"{name}: FP32 step loss {float(m['loss'])}, launches {counts}")
        rep[name] = {"fp32_loss": float(m["loss"]), "launches": counts}
        del state, model
        torch.cuda.empty_cache()
    log(f"[zoo] QAT steps at {IMAGE}x{IMAGE}, batch {BATCH}: "
        + ", ".join(f"{n} loss {r.get('qat_loss', r.get('fp32_loss')):.4f} "
                    f"({r['launches']['fake_quant_observe']} fake-quant launches)"
                    for n, r in rep.items()))
    return rep, launches


def train_seg_against_zoo_reference(name, dev):
    """Phase 20, part f: a segmentation fixture's train step (ESPNet,
    ESPNetv2 at ``s`` 2.0) against its committed JAX reference at 768x768,
    batch 2 (float32, TF32 off): one FP32 step, ``start_qat``, one QAT step;
    the losses, every observer and BN in phase 8's bands; the fake-quant
    launches per step (0, then one a site)."""
    from frostnet_tpu_torch.segmentation import train as seg_train
    from frostnet_tpu_torch.segmentation.data import CITYSCAPES_CLASS_WEIGHTS

    ref = np.load(os.path.join(TESTDATA, f"zoo_{name}_train_reference.npz"))
    meta = json.loads(bytes(ref["__meta__"]).decode())
    model = zoo_model(meta["model"])
    n_sites = observers(model)
    tx = get_optimizer("QSGD", meta["lr"], weight_decay=grouped_weight_decay(meta["wd"]),
                       noise_decay=1.0)
    state = create_train_state(model, tx, seed=meta["seed"], device=dev)
    losses, per_step = [], []
    ops.reset_launch_counts()
    for k, mode in enumerate((FP32, QAT)):
        if k == 1:
            state.start_qat()
        before = ops.fake_quant_observe.launches
        m = seg_train.make_seg_train_step(mode, CITYSCAPES_CLASS_WEIGHTS, 255, SEG_CLASSES)(
            state, seg_train_batch(k, meta["crop"], meta["batch"]))
        losses.append(float(m["loss"]))
        per_step.append(ops.fake_quant_observe.launches - before)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if per_step != [0, n_sites]:
        raise AssertionError(f"{name} steps: fake_quant_observe launches {per_step} != "
                             f"[0, {n_sites}]")
    rel = [abs(a - float(b)) / float(b) for a, b in zip(losses, ref["loss"])]
    band_check(f"{name} FP32 step loss, relative to JAX", rel[0], FP32_LOSS_REL)
    band_check(f"{name} QAT step loss, relative to JAX", rel[1], QAT_LOSS_REL)
    mine = {k: v.detach().cpu().numpy() for k, v in model_variables(state.model).items()}
    obs = []
    for k in ref.files:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(ref[hi] - ref[k]), 1e-6)
            obs.append(max(abs(float(mine[k] - ref[k])), abs(float(mine[hi] - ref[hi]))) / span)
    if len(obs) != n_sites:
        raise AssertionError(f"{len(obs)} observers in the reference, {n_sites} in the model")
    band_check(f"{name} observers, median |diff| / range", float(np.median(obs)), OBS_MEDIAN)
    band_check(f"{name} observers, worst |diff| / range", float(max(obs)), OBS_WORST)
    bn_mean = [float(np.max(np.abs(mine[k] - ref[k]) / np.sqrt(ref[k[:-4] + "var"])))
               for k in ref.files if k.endswith("/mean")]
    band_check(f"{name} BN means, median |diff| / std", float(np.median(bn_mean)), BN_MEAN_MEDIAN)
    rep = {"losses": losses, "loss_rel": rel, "launches_per_step": per_step,
           "observer_rel_range": {"median": float(np.median(obs)), "worst": float(max(obs))},
           "bn_mean_over_std_median": float(np.median(bn_mean))}
    log(f"[zoo] {name} train steps at {meta['crop']}x{meta['crop']}, batch {meta['batch']} "
        f"against the JAX reference: losses {losses} (relative {rel}); observers "
        f"{rep['observer_rel_range']} of their range; BN means {rep['bn_mean_over_std_median']:.3g}"
        f" of a std (median); fake_quant_observe launches per step {per_step}")
    del state, model
    torch.cuda.empty_cache()
    return rep, launches


def zoo_seg_trainer_path(dev):
    """Phase 20, part g: ``segmentation.train.main`` on ``espnetv2
    --width_scale 2.0`` at 768x768 (batch 4, one FP32 and one QAT epoch of
    one step), then ``evaluate.main --export_int8`` on ``best/``: finite
    losses and mIoUs, each step's launches as the model's sites and routes
    say."""
    from frostnet_tpu_torch.segmentation import evaluate as seg_eval
    from frostnet_tpu_torch.segmentation import get_seg_model, train as seg_train

    cfg = ZOO_SEG_TRAINER_CFG
    root = os.path.join(PHASE20_DIR, "trainer")
    shutil.rmtree(root, ignore_errors=True)
    save_dir = os.path.join(root, "run")
    probe = get_seg_model(cfg["model"], s=cfg["width_scale"], num_classes=SEG_CLASSES)
    n_sites = observers(probe)
    probe.prepare_int8("cpu")
    n_int8 = route_counts(probe)
    zero = {"fake_quant_observe": 0, "int8_matmul_requant": 0, "int8_conv": 0,
            "depthwise_int8": 0, "resize_bilinear": 0}
    rz = {**zero, "resize_bilinear": n_int8["resize_bilinear"]}
    expect = {("train", FP32): rz,
              ("train", QAT): {**rz, "fake_quant_observe": n_sites},
              ("eval", QAT_FROZEN): {**rz, "fake_quant_observe": n_sites},
              ("eval", INT8): {**zero, "int8_matmul_requant": n_int8["int8_matmul_requant"],
                               "int8_conv": n_int8["int8_conv"],
                               "depthwise_int8": n_int8["depthwise_int8"],
                               "resize_bilinear": n_int8["resize_bilinear"]}}
    names = ("make_seg_train_step", "make_seg_eval_step")
    rep = {}
    with StepCounter(seg_train, *names) as counter:
        _, res = seg_train.main(seg_train.SegConfig(save_dir=save_dir, device=dev.type, **cfg))
    rep["train_steps"] = check_step_launches(counter.rows, "espnetv2 train run", expect)
    for h in res["history"]:
        if not np.isfinite(h["loss"]):
            raise AssertionError(f"espnetv2 trainer: {h['tag']} loss {h['loss']}")
    rep["epochs"] = [{"tag": h["tag"], "loss": h["loss"], "images_per_sec": h["images_per_sec"]}
                     for h in res["history"]]
    artifact = os.path.join(root, "espnetv2_int8.npz")
    with StepCounter(seg_train, *names) as counter:
        ev = seg_eval.main(seg_eval.build_parser().parse_args(
            ["--model", cfg["model"], "--width_scale", str(cfg["width_scale"]), "--crop_size",
             str(cfg["crop_size"]), "--batch_size", str(cfg["batch_size"]), "--device", dev.type,
             "--checkpoint", os.path.join(save_dir, "best"), "--export_int8", artifact]))
    rep["evaluate_steps"] = check_step_launches(counter.rows, "espnetv2 evaluate", expect)
    if not (np.isfinite(ev["qat"]) and np.isfinite(ev["int8"])):
        raise AssertionError(f"espnetv2 evaluate: mIoU {ev['qat']} {ev['int8']}")
    rep["trainer_miou"] = {k: res[k]["miou"] for k in ("qat", "int8")}
    rep["evaluate_miou"] = {"qat": ev["qat"], "int8": ev["int8"],
                            "export_bytes": ev["export_bytes"]}
    log(f"[zoo] espnetv2 --width_scale 2.0 trainer at {cfg['crop_size']}x{cfg['crop_size']}: "
        f"steps {rep['train_steps']} (fake_quant_observe {n_sites} per QAT step; INT8 forward "
        f"{n_int8}); epochs {rep['epochs']}; mIoU QAT sim {rep['trainer_miou']['qat']:.4f}, INT8 "
        f"{rep['trainer_miou']['int8']:.4f}; evaluate.main on best/: {rep['evaluate_miou']}")
    return rep


def zoo_phase(dev):
    """Phase 20: the rest of the zoo on the card. Returns (report, launches
    of each path, conv rows, max errors)."""
    os.makedirs(PHASE20_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep, launches = {}, {}
    rep["classifiers"], err, paths, odd = serve_zoo_classifiers(dev)
    launches.update(paths)
    rep["segmentation"], paths, seg_odd, served = serve_zoo_segs(dev)
    launches.update(paths)
    del served
    torch.cuda.empty_cache()
    e, odd_rows = check_odd_convs(odd + seg_odd, dev)
    err["int8_conv"] = max(err["int8_conv"], e)
    rep["odd_convs"] = [r["shape"] for r in odd_rows]
    rep["training"], paths = train_zoo_classifiers(dev)
    launches.update(paths)
    for name in ZOO_SEG:
        rep[f"{name}_train"], launches[f"{name} train check"] = \
            train_seg_against_zoo_reference(name, dev)
    ops.reset_launch_counts()
    rep["trainer"] = zoo_seg_trainer_path(dev)
    launches["espnetv2 trainer"] = ops.launch_counts()
    for k in ("fake_quant_observe", "int8_matmul_requant", "int8_conv", "depthwise_int8"):
        if sum(c[k] for c in launches.values()) == 0:
            raise AssertionError(f"phase 20 launched no {k}")
    seen = {r["shape"].split(" ")[-1] for r in odd_rows}
    conv_rows = odd_rows + [r for r in rep["classifiers"]["qvgg16_bn"].pop("conv_rows")
                            if r["shape"].split(" ")[-1] not in seen]
    return rep, launches, conv_rows, err

# ---------------------------------------------------------------------------
# Phase 21: the rest of serving and the model tools
# ---------------------------------------------------------------------------

PHASE21_DIR = os.path.join(ROOT, "build", "phase21")
SERVE_SEG = ("mobilenetv3_large", 512, 1024, 8)  # the JAX server's seg default, batch 8
SERVE_ITERS = 3
PROGRAM_BATCHES = (8, 128)
DILATED = ((16, 224, BATCH), (8, 224, BATCH), (16, 512, 2), (8, 512, 2))  # stride, size, batch
LATENCY_MODELS = ("qmobilenet_v2_ReLU", MODEL)


class plain_kernels:
    """Within the block, the INT8 graph's kernel calls go to their plain
    versions: the comparison path, on the card as on the CPU (the modules
    look the wrappers up by name when they run; every resize goes through
    ``ops.resize``)."""

    def __enter__(self):
        import frostnet_tpu_torch.models.frostnet as frostnet_mod
        import frostnet_tpu_torch.nn.conv as conv_mod
        import frostnet_tpu_torch.ops.resize as resize_mod

        self.saved = [(conv_mod, "int8_matmul_requant", int8_matmul_requant_plain),
                      (conv_mod, "conv3x3_s1_int8", conv3x3_s1_int8_plain),
                      (conv_mod, "depthwise_int8", depthwise_int8_plain),
                      (frostnet_mod, "frost_block_int8", frost_block_int8_plain),
                      (resize_mod, "resize_bilinear", resize_bilinear_plain)]
        self.saved = [(mod, name, getattr(mod, name), plain) for mod, name, plain in self.saved]
        for mod, name, _, plain in self.saved:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, kernel, _ in self.saved:
            setattr(mod, name, kernel)


def served_forwards(iters: int, extra: int = 0) -> int:
    """Forwards of one ``serve.main`` run: the warm-up, ``iters`` timed
    requests, ``iters`` pipelined ones, and ``extra`` (saved logits, the
    predicted batches)."""
    return 1 + 2 * iters + extra


def per_forward(counts: dict, forwards: int, what: str) -> dict:
    if any(v % forwards for v in counts.values()):
        raise AssertionError(f"{what}: launches {counts} are not a multiple of {forwards} forwards")
    return {k: v // forwards for k, v in counts.items()}


def serve_seg_phase(dev):
    """Phase 21a: ``serve.main --workload seg`` on ``mobilenetv3_large`` at
    512x1024, batch 8, over the port's export of the committed calibration:
    the report, the PNG count and the launches a forward; then the same
    model's kernel path against its plain path on the card, every layer's
    codes, the logits and the class maps."""
    from frostnet_tpu_torch.segmentation import get_seg_model

    name, h, w, b = SERVE_SEG
    trained = from_jax_variables(get_seg_model(name, num_classes=SEG_CLASSES),
                                 unflatten_variables(seg_variables(name)))
    artifact = os.path.join(PHASE21_DIR, f"seg_{name}_int8.npz")
    export_int8(trained, artifact)
    maps = os.path.join(PHASE21_DIR, "seg_maps")
    shutil.rmtree(maps, ignore_errors=True)
    ops.reset_launch_counts()
    rep = serve.main(serve.build_parser().parse_args(
        ["--workload", "seg", "--artifact", artifact, "--num_classes", str(SEG_CLASSES),
         "--batch_size", str(b), "--iters", str(SERVE_ITERS), "--output", maps,
         "--predict_batches", "1"]))
    torch.cuda.synchronize()
    launches = per_forward(ops.launch_counts(), served_forwards(SERVE_ITERS, 1), "seg serving")
    pngs = sorted(os.listdir(maps))
    if pngs != [f"pred_{i:05d}.png" for i in range(b)]:
        raise AssertionError(f"seg serving wrote {pngs}, not {b} class maps")
    pred = serve.seg_predictor(name, artifact, SEG_CLASSES, h, dev)
    n_mm, n_dw = len(matmul_convs(pred.model)), len(depthwise_convs(pred.model))
    if launches != {"int8_matmul_requant": n_mm, "frost_block_int8": 0, "fake_quant_observe": 0,
                    "int8_conv": 0, "depthwise_int8": n_dw,
                    "resize_bilinear": resize_sites(pred.model)}:
        raise AssertionError(f"seg serving: launches a forward {launches}, {n_mm} matmuls and "
                             f"{n_dw} depthwise convs expected")
    x = torch.as_tensor(np.random.RandomState(21).randn(b, h, w, 3).astype(np.float32),
                        device=dev)
    logits, codes = seg_layer_codes(pred.model, pred, x)
    with plain_kernels():
        plain_logits, plain_codes = seg_layer_codes(pred.model, pred, x)
    if set(codes) != set(plain_codes):
        raise AssertionError("seg: the kernel and plain paths record other layers")
    for layer, q in codes.items():
        check_equal(f"seg {layer}", q, plain_codes[layer])
    classes = logits.argmax(dim=-1)
    if not torch.equal(classes, plain_logits.argmax(dim=-1)) or not torch.equal(logits,
                                                                               plain_logits):
        raise AssertionError("seg: class maps or logits of the kernel path != the plain path")
    if logits.shape != (b, h, w, SEG_CLASSES) or len(torch.unique(classes)) < 2:
        raise AssertionError(f"seg: logits {tuple(logits.shape)}, classes "
                             f"{torch.unique(classes).tolist()}")
    out = {"report": rep, "launches": launches, "layers": len(codes), "pngs": len(pngs),
           "classes": len(torch.unique(classes))}
    log(f"[tools] serve --workload seg {name} {h}x{w} batch {b}: "
        f"{rep['request_images_per_sec']} images/s a request (p50 {rep['latency_ms']['p50']} ms, "
        f"p95 {rep['latency_ms']['p95']} ms), {rep['pipeline_images_per_sec']} pipelined; "
        f"{launches['int8_matmul_requant']} matmul and {launches['depthwise_int8']} depthwise "
        f"launches a forward; {len(pngs)} PNGs; "
        f"codes at {len(codes)} layers, logits and class maps == the plain path on the card")
    return out, ops.launch_counts()


def program_phase(dev):
    """Phase 21b: the serialized program of the committed INT8 fixture, fused
    and unfused: exported once on a symbolic batch, served by ``serve.main
    --program`` at batch 8 and 128 (logits bit-equal to the in-process
    ``Int8Predictor``, and the same launches a forward, the depthwise kernel's
    among them); the program loaded in
    this process and the in-process model timed with CUDA events, as phase 6
    times serving. The block op's launch plans go with the dropped
    programs."""
    from frostnet_tpu_torch.ops import frost_block

    out, launches = {}, {}
    expect = {True: {"frost_block_int8": 18, "int8_matmul_requant": 3, "fake_quant_observe": 0,
                     "int8_conv": 0, "depthwise_int8": 0, "resize_bilinear": 0},
              False: {"frost_block_int8": 0, "int8_matmul_requant": 52, "fake_quant_observe": 0,
                      "int8_conv": 0, "depthwise_int8": 18, "resize_bilinear": 0}}
    for fuse in (True, False):
        what = "fused" if fuse else "unfused"
        pred = Int8Predictor(MODEL, artifact=ARTIFACT, image_size=IMAGE, fuse_int8=fuse,
                             device=dev)
        path = os.path.join(PHASE21_DIR, f"{MODEL}_{what}.pt2")
        t0 = time.perf_counter()
        nbytes = pred.export_program(path)
        t1 = time.perf_counter()
        prog = Int8Predictor(program=path, device=dev)
        rec = {"export_s": t1 - t0, "load_s": time.perf_counter() - t1, "bytes": nbytes}
        for b in PROGRAM_BATCHES:
            saved = os.path.join(PHASE21_DIR, f"program_{what}_{b}.npy")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rep = serve.main(serve.build_parser().parse_args(
                ["--program", path, "--image_size", str(IMAGE), "--batch_size", str(b),
                 "--iters", str(SERVE_ITERS), "--save_logits", saved]))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            launches[f"program {what} bs{b}"] = counts
            got = per_forward(counts, served_forwards(SERVE_ITERS, 1), f"program {what}")
            if got != expect[fuse]:
                raise AssertionError(f"program {what} batch {b}: launches a forward {got} != "
                                     f"{expect[fuse]}")
            x = torch.as_tensor(np.random.RandomState(0).randn(b, IMAGE, IMAGE, 3)
                                .astype(np.float32), device=dev)
            ops.reset_launch_counts()
            want = pred(x).cpu()
            if ops.launch_counts() != got:
                raise AssertionError(f"program {what} batch {b}: launches a forward {got} != "
                                     f"the in-process predictor's {ops.launch_counts()}")
            if not (torch.equal(torch.as_tensor(np.load(saved)), want)
                    and torch.equal(prog(x).cpu(), want)):
                raise AssertionError(f"program {what} batch {b}: logits != the in-process "
                                     "predictor's")
            reps = 10 if fuse else 3
            rec[f"bs{b}"] = {"program_ms": time_ms(lambda: prog(x), reps, warmup=1),
                             "in_process_ms": time_ms(lambda: pred(x), reps, warmup=1),
                             "serve_main": rep, "serve_main_s": wall}
            log(f"[tools] program {what} batch {b}: serve.main --program logits == in-process "
                f"predictor, launches a forward {got} ({wall:.1f} s); "
                f"{rec[f'bs{b}']['program_ms']:.3f} ms a batch (in-process "
                f"{rec[f'bs{b}']['in_process_ms']:.3f}), CUDA events")
        log(f"[tools] program {what}: {nbytes / 1e6:.2f} MB, exported in {rec['export_s']:.1f} s, "
            f"loaded in {rec['load_s']:.1f} s")
        out[what] = rec
        plans = len(frost_block._PLANS)
        del pred, prog
        gc.collect()
        if len(frost_block._PLANS) != 0:
            raise AssertionError(f"program {what}: {len(frost_block._PLANS)} of {plans} block "
                                 "launch plans outlived the programs")
    return out, launches


def dilated_phase(dev):
    """Phase 21c: ``FrostNet(output_stride=16|8)`` with ``features_only`` from
    the fixture's variables, INT8 with ``fuse_int8``: the four features
    bit-equal to the plain path on the card; the block kernel only at the
    undilated blocks, the matmul kernel at the stem and the dilated blocks'
    1x1s, the depthwise kernel at the dilated blocks' depthwise convs."""
    from frostnet_tpu_torch.quant import load_int8
    from frostnet_tpu_torch.quant.export import artifact_qconfig

    out, launches = {}, {}
    variables = load_int8(ARTIFACT)
    for os_, size, b in DILATED:
        model = from_jax_variables(create_model(MODEL, output_stride=os_, fuse_int8=True,
                                                qconfig=artifact_qconfig(ARTIFACT)), variables)
        freeze(model, dev, image_size=size)
        dilated = [blk for blk in model.blocks if blk.dilation > 1]
        expect = {"frost_block_int8": len(model.block_specs(size)),
                  "int8_matmul_requant": 1 + sum(blk.has_squeeze + blk.has_expand + 1
                                                 for blk in dilated),
                  "fake_quant_observe": 0, "int8_conv": 0, "depthwise_int8": len(dilated),
                  "resize_bilinear": 0}
        x = torch.as_tensor(np.random.RandomState(os_ + size).randn(b, size, size, 3)
                            .astype(np.float32), device=dev)
        ops.reset_launch_counts()
        with torch.inference_mode():
            feats = model(x, mode=INT8, features_only=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launches[f"os{os_} {size}"] = counts
        if counts != expect:
            raise AssertionError(f"output_stride {os_} at {size}: launches {counts} != {expect}")
        with plain_kernels(), torch.inference_mode():
            plain = model(x, mode=INT8, features_only=True)
        for i, (f, p) in enumerate(zip(feats, plain)):
            if not torch.equal(f, p) or not torch.isfinite(f).all():
                raise AssertionError(f"output_stride {os_} at {size}: feature {i} != plain path")
        out[f"os{os_}_{size}"] = {"shapes": [tuple(f.shape) for f in feats], "launches": counts}
        log(f"[tools] FrostNet output_stride {os_} at {size}, batch {b}: features "
            f"{[tuple(f.shape[1:]) for f in feats]} == plain path; {counts['frost_block_int8']} "
            f"undilated blocks on the block kernel, {counts['int8_matmul_requant']} matmuls "
            f"(the stem and the {len(dilated)} dilated blocks' 1x1s)")
        del model, feats, plain
    return out, launches


def numeric_suite_phase(dev):
    """Phase 21d: ``compare_modes`` on the full-width fixture at batch 8, INT8
    against QAT_FROZEN (the fake-quant kernel at its sites): the row set and
    shapes equal to the port's CPU run; the worst 5 rows printed."""
    from frostnet_tpu_torch.quant import load_int8
    from frostnet_tpu_torch.quant.numeric_suite import compare_modes, format_report

    x = np.random.RandomState(22).randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    # on the card, the model of a fused predictor that has served (its blocks'
    # launch plans made): the suite compares an unfused copy of it
    pred = Int8Predictor(MODEL, artifact=ARTIFACT, image_size=IMAGE, fuse_int8=True, device=dev)
    served = pred(x)
    ops.reset_launch_counts()
    rows = {"card": compare_modes(pred.model, x)}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts["fake_quant_observe"] != N_SITES or counts["int8_matmul_requant"] != 52 or \
            counts["depthwise_int8"] != 18:
        raise AssertionError(f"numeric suite launches {counts}: {N_SITES} fake-quant sites, "
                             "52 matmuls and 18 depthwise convs expected")
    ops.reset_launch_counts()
    if not torch.equal(pred(x), served) or ops.launch_counts()["frost_block_int8"] != 18:
        raise AssertionError("numeric suite: the predictor no longer serves as before")
    rows["cpu"] = compare_modes(from_jax_variables(create_model(MODEL), load_int8(ARTIFACT)), x)
    shapes = {where: {r.path: r.shape for r in rs} for where, rs in rows.items()}
    if shapes["card"] != shapes["cpu"]:
        raise AssertionError("numeric suite: the card's rows != the CPU's")
    worst = format_report(rows["card"], 5)
    log(f"[tools] numeric suite, {MODEL} at {IMAGE}, batch {BATCH}: {len(rows['card'])} rows "
        f"== the CPU run's paths and shapes; launches {counts}; worst 5:\n{worst}")
    return ({"rows": len(rows["card"]), "worst": [dataclass_row(r) for r in rows["card"][:5]],
             "cpu_worst": [dataclass_row(r) for r in rows["cpu"][:5]]}, counts)


def dataclass_row(r) -> dict:
    return {"path": r.path, "shape": list(r.shape), "sqnr_db": r.sqnr_db,
            "max_quanta": r.max_quanta}


def latency_phase(dev):
    """Phase 21e: ``latency_check.main`` (fbgemm, batch 1) for the default
    ``qmobilenet_v2_ReLU`` and for ``frostnet_quant_large_1_0``."""
    from frostnet_tpu_torch.train import latency_check

    out, launches = {}, {}
    for name in LATENCY_MODELS:
        ops.reset_launch_counts()
        rep = latency_check.cli(["--model", name, "--iters", "20"])
        launches[f"latency {name}"] = ops.launch_counts()
        if (torch.device(rep["device"]).type != dev.type
                or not all(rep[k] > 0 for k in ("fp_ms", "qat_ms", "int8_ms"))):
            raise AssertionError(f"latency_check {name}: {rep}")
        out[name] = rep
        log(f"[tools] latency_check {name} (fbgemm, batch 1): FP32 {rep['fp_ms']:.3f}, QAT_FROZEN "
            f"{rep['qat_ms']:.3f}, INT8 {rep['int8_ms']:.3f} ms a batch; size FP32 "
            f"{rep['fp_size_mb']:.2f} MB, INT8 {rep['int8_size_mb']:.2f} MB")
    return out, launches


def tools_phase(dev):
    """Phase 21: seg serving, the serialized programs, the dilated features,
    the numeric suite and the latency probe. Returns (report, launches of
    each path)."""
    os.makedirs(PHASE21_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep, launches, seconds = {}, {}, {}
    for key, fn in (("seg_serving", serve_seg_phase), ("program", program_phase),
                    ("dilated", dilated_phase), ("numeric_suite", numeric_suite_phase),
                    ("latency", latency_phase)):
        t0 = time.perf_counter()
        rep[key], paths = fn(dev)
        seconds[key] = time.perf_counter() - t0
        launches.update({key.replace("_", " "): paths} if key in ("seg_serving", "numeric_suite")
                        else paths)
        torch.cuda.empty_cache()
    rep["seconds"] = seconds
    log(f"[tools] phase 21 in {sum(seconds.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return rep, launches


PHASE22_DIR = os.path.join(ROOT, "build", "phase22")
DP_WORLD, DP_BATCH = 2, 128  # phase 22 (b): two ranks on one card, the global batch
DP_STEPS = ("FP32", "QAT", "QAT")
DP_TIMEOUT = 150  # seconds the ranks may take, their start included
# launches of fused serving at batch 8 on two replicas: 18 blocks + 3 matmuls each
DP_SERVE_LAUNCHES = {"frost_block_int8": 36, "int8_matmul_requant": 6, "fake_quant_observe": 0,
                     "int8_conv": 0, "depthwise_int8": 0, "resize_bilinear": 0}


def native_phase(dev):
    """Phase 22 (a): the native loaders where g++ finds libjpeg and libpng;
    where it does not, the build raises with the compiler's message and the
    trainer asked for ``loader='native'`` raises it too (no fallback)."""
    from frostnet_tpu_torch import native
    from frostnet_tpu_torch.train import classification

    rep = {}
    try:
        native.build()
    except RuntimeError as e:
        missing = [h for h in ("jpeglib.h", "png.h") if h in str(e)]
        rep["built"], rep["missing"] = False, missing
        log(f"[native] libjpeg and libpng are absent on this machine ({', '.join(missing) or 'the build failed'}): the native loaders cannot be built here; phase 22 (a) checks that they raise")
        folder = os.path.join(PHASE22_DIR, "native_data", "imagenet", "train", "class0")
        os.makedirs(folder, exist_ok=True)
        cfg = classification.ClassificationConfig(
            dataset="imagenet", loader="native", data_dir=os.path.join(PHASE22_DIR, "native_data"),
            device=str(dev))
        try:
            classification._build_dataset(cfg, train=True)
        except RuntimeError as e2:
            if "build failed" not in str(e2):
                raise
        else:
            raise AssertionError("loader='native' did not raise without libjpeg and libpng")
        rep["trainer_raises"] = True
        log("[native] classification._build_dataset(loader='native') raises the build error; "
            "the images/s of the native loaders and of `classification.main --loader native` "
            "are not measured on this machine")
        return rep
    rep["built"] = True
    # libjpeg and libpng present: the seg and det pools on PNGs written
    # without PIL (the classification pool reads JPEGs, which nothing here writes)
    from frostnet_tpu_torch.gan.visualizer import write_png

    root = os.path.join(PHASE22_DIR, "native")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    imgs, masks = [], []
    for i in range(8):
        h, w = 512 + 32 * i, 1024 - 32 * i
        imgs.append(os.path.join(root, f"img{i}.png"))
        masks.append(os.path.join(root, f"mask{i}.png"))
        coarse = rng.randint(0, 256, (h // 16, w // 16, 3)).astype(np.uint8)
        write_png(imgs[-1], np.repeat(np.repeat(coarse, 16, 0), 16, 1))
        mask = np.repeat(np.repeat(rng.randint(0, 19, (h // 16, w // 16)), 16, 0), 16, 1)
        write_png(masks[-1], np.repeat(mask.astype(np.uint8)[..., None], 3, -1))
    boxes = [np.asarray([[10, 20, 200, 300]], np.float32)] * len(imgs)
    labels = [np.asarray([3], np.int32)] * len(imgs)

    def make(kind, **kw):
        if kind == "seg":
            return native.NativeSegmentationLoader(imgs, masks, crop_size=(64, 64), batch_size=4,
                                                   seed=1, **kw)
        return native.NativeDetectionLoader(imgs, boxes, labels, batch_size=4, size=64, seed=1,
                                            **kw)

    for kind in ("seg", "det"):
        whole = list(make(kind, threads=1))
        parts = [list(make(kind, threads=1, rank=r, world=2)) for r in range(2)]
        for b, w in enumerate(whole):
            for k in w:
                if not np.array_equal(np.concatenate([p[b][k] for p in parts]), w[k]):
                    raise AssertionError(f"native {kind}: rank blocks != the batch ({k})")
        loader = (native.NativeSegmentationLoader(imgs * 64, masks * 64, crop_size=(768, 768),
                                                  batch_size=16, threads=32, seed=1)
                  if kind == "seg" else
                  native.NativeDetectionLoader(imgs * 64, boxes * 64, labels * 64, batch_size=256,
                                               threads=32, seed=1))
        t0, n = time.perf_counter(), 0
        for batch in loader:
            n += len(batch["image"])
        rep[f"{kind}_images_per_sec"] = n / (time.perf_counter() - t0)
        log(f"[native] {kind}: rank blocks == the batch at threads=1; "
            f"{rep[f'{kind}_images_per_sec']:.1f} images/s (32 threads)")
    return rep


class _DPSiteCheck:
    """Stands in for ``quant_ops.ObservedFakeQuant`` during a step: each
    observing site runs as usual (its route: the data-parallel one at
    activation sites, the one-launch kernel at the replicated weight sites),
    then the same kernel call again on a copy of the old state (its launches
    and its all-reduce left out of the counts) is held against the plain
    version on the global min and max (activation sites) or on the local
    batch: y, the mask, the new state and the qparams, bit for bit."""

    real = ObservedFakeQuant
    record: list = []

    @classmethod
    def apply(cls, x, obs, spec, observe, mesh=None):
        old = ObserverState(obs.min_val.detach().clone(), obs.max_val.detach().clone())
        y = cls.real.apply(x, obs, spec, observe, mesh)
        counts = (fake_quant_observe.launches, fake_quant_observe.dp_launches)
        kmin, kmax = old.min_val.clone(), old.max_val.clone()
        xd = x.detach()
        ky, kmask, kqp = fake_quant_observe(xd, kmin, kmax, spec, observe, mesh)
        batch = None if mesh is None else global_batch_min_max(xd, mesh)
        fake_quant_observe.launches, fake_quant_observe.dp_launches = counts
        py, pmask, st, ps, pz = fake_quant_observe_plain(xd, old, spec, True, batch=batch)
        for name, g, w in (("y", ky, py), ("y of the step", y.detach(), py),
                           ("mask", kmask, pmask), ("min_val", kmin, st.min_val),
                           ("max_val", kmax, st.max_val), ("scale", kqp[0], ps),
                           ("zero_point", kqp[1], pz.to(torch.float32))):
            if not torch.equal(g, w):
                raise AssertionError(f"fake-quant site {len(cls.record)} {tuple(x.shape)} "
                                     f"({'one-launch' if mesh is None else 'data-parallel'} "
                                     f"route): {name} != plain version")
        cls.record.append({"shape": list(x.shape), "route": "one_launch" if mesh is None else "dp",
                           "max_abs_err": float((ky.float() - py.float()).abs().max())})
        return y


def dp_rank(rank: int, world: int, store: str, out: str, device: str = "cuda"):
    """One rank of phase 22 (b), in its own process on ``cuda:0``: the
    FrostNet FP32 step and two QAT steps on the global batches
    ``train_batch(k, DP_BATCH)``, phase 8's settings (float32, TF32 off,
    GradBoost noise off, drop_rate 0), this rank's block of rows, the state
    replicated from rank 0 (rank 1 starts from another seed). The first QAT
    step checks every fake-quant site against its plain version. Writes the
    variables and metrics to ``out``-rank.npz and the launches, times and
    site checks to ``out``-rank.json (the checking step's time includes
    its checks)."""
    from frostnet_tpu_torch.parallel import make_mesh, multihost, replicate, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(device, init_method=f"file://{store}", rank=rank, world_size=world)
    dev = multihost.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh()
    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(model, tx, seed=rank, device=dev)
    replicate(state.model, mesh)
    rec, info = {}, {"steps": [], "sites": []}
    for k, name in enumerate(DP_STEPS):
        mode = FP32 if name == "FP32" else QAT
        if mode is QAT and DP_STEPS[k - 1] == "FP32":
            state.start_qat()
        batch = {n: torch.as_tensor(v).to(dev)
                 for n, v in shard_batch(train_batch(k, DP_BATCH), mesh).items()}
        step = make_train_step(mode, num_classes=CLASSES, mesh=mesh)
        if k == 1:  # the first QAT step checks its sites
            _DPSiteCheck.record = info["sites"]
            quant_ops.ObservedFakeQuant = _DPSiteCheck
        ops.reset_launch_counts()
        fake_quant_observe.dp_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            m = step(state, batch)
            torch.cuda.synchronize()
        finally:
            quant_ops.ObservedFakeQuant = ObservedFakeQuant
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        counts["fake_quant_dp_route"] = fake_quant_observe.dp_launches
        info["steps"].append({"step": name, "ms": ms, "launches": counts,
                              **{n: float(v) for n, v in m.items()}})
        rec.update({f"metrics/{k}/{n}": float(v) for n, v in m.items()})
    rec.update({n: v.detach().cpu().numpy() for n, v in model_variables(state.model).items()})
    np.savez(f"{out}-{rank}.npz", **rec)
    info["device"] = str(dev)
    with open(f"{out}-{rank}.json", "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


def _twin_mesh():
    """Rank 0 of two data-parallel replicas that hold the same rows: a real
    ``Mesh`` whose all-reduce stays local (a sum doubled, a min or max as it
    is). Phase 22 times the data-parallel route's kernels with it, without
    a collective, so that a CUDA graph can hold them."""
    import dataclasses

    from torch.distributed import ReduceOp

    from frostnet_tpu_torch.parallel import Mesh

    @dataclasses.dataclass(frozen=True)
    class TwinMesh(Mesh):
        def all_reduce(self, t, op=ReduceOp.SUM):
            return t.mul_(self.dp) if op == ReduceOp.SUM else t

    return TwinMesh(devices=(0, 1), group="twin", rank=0)


def dp_route_timing(dev):
    """The data-parallel fake-quant route (two launches a site) at the
    activation sites of a rank's QAT forward (batch DP_BATCH / DP_WORLD),
    against the plain version bit for bit, and its device time beside the
    one-launch kernel's on the same sites, its bound and the plain time."""
    from frostnet_tpu_torch.parallel import data_parallel

    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    from_jax_variables(model, numpy_init(model, 0)).to(dev)
    images = prep_image(torch.as_tensor(train_batch(1, DP_BATCH // DP_WORLD)["image"],
                                        device=dev))
    sites, real, mesh = [], quant_ops.ObservedFakeQuant, _twin_mesh()

    class Recorder:
        @staticmethod
        def apply(x, obs, spec, observe, mesh=None):
            if mesh is not None:  # an activation site (weight sites observe no mesh)
                sites.append((x.detach().clone(), obs.min_val.detach().clone(),
                              obs.max_val.detach().clone(), spec))
            return real.apply(x, obs, spec, observe, mesh)

    quant_ops.ObservedFakeQuant = Recorder
    try:
        with torch.no_grad(), data_parallel(mesh):
            model(images, mode=QAT, train=True)
    finally:
        quant_ops.ObservedFakeQuant = real
    err = 0.0
    for x, mn, mx, spec in sites:
        kmin, kmax = mn.clone(), mx.clone()
        y, mask, qp = fake_quant_observe(x, kmin, kmax, spec, mesh=mesh)
        py, pmask, st, ps, pz = fake_quant_observe_plain(x, ObserverState(mn, mx), spec, True)
        if not (torch.equal(y, py) and torch.equal(mask, pmask) and torch.equal(kmin, st.min_val)
                and torch.equal(kmax, st.max_val) and torch.equal(qp[0], ps)
                and torch.equal(qp[1], pz.to(torch.float32))):
            raise AssertionError(f"data-parallel route != plain at {tuple(x.shape)}")
        err = max(err, float((y - py).abs().max()))
    states = [(mn.clone(), mx.clone()) for _, mn, mx, _ in sites]

    def route(m):
        def fn():
            for (x, _, _, spec), (mn, mx) in zip(sites, states):
                fake_quant_observe(x, mn, mx, spec, mesh=m)
        return fn

    before = fake_quant_observe.dp_launches
    route(mesh)()
    per_site = (fake_quant_observe.dp_launches - before) / len(sites)
    nbytes = sum(fq_cost(x)[0] for x, _, _, _ in sites)
    nops = sum(fq_cost(x)[1] for x, _, _, _ in sites)
    bound_ms, bound_by = bound(nbytes, nops, PEAK_F32_OPS_PER_S)

    def plain_all():
        for x, mn, mx, spec in sites:
            fake_quant_observe_plain(x, ObserverState(mn, mx), spec)

    rep = {"sites": len(sites), "launches_per_site": per_site, "max_abs_err": err,
           "graph_ms": graph_ms(route(mesh), 5), "one_launch_graph_ms": graph_ms(route(None), 5),
           "wall_ms": time_ms(route(mesh), reps=5), "plain_ms": time_ms(plain_all, reps=2),
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[dp] the data-parallel fake-quant route at the {len(sites)} activation sites of a "
        f"rank's QAT forward (batch {DP_BATCH // DP_WORLD}): == plain; {per_site:g} launches a "
        f"site; {rep['graph_ms']:.4f} ms device (CUDA graph, the collective left out) against "
        f"{rep['one_launch_graph_ms']:.4f} ms for the one-launch kernel on the same sites; "
        f"{rep['wall_ms']:.4f} ms wall; bound {bound_ms:.4f} ms ({bound_by}); plain "
        f"{rep['plain_ms']:.3f} ms")
    return rep


def dp_step_phase(dev):
    """Phase 22 (b): the one-process steps on the global batch, then two
    ranks over gloo on this card (``dp_rank``), then their checks."""
    os.makedirs(PHASE22_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store, out = os.path.join(PHASE22_DIR, "store"), os.path.join(PHASE22_DIR, "rank")
    for f in os.listdir(PHASE22_DIR):
        if f.startswith(("store", "rank")):
            os.remove(os.path.join(PHASE22_DIR, f))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.dp_rank({r}, {DP_WORLD}, "
                               f"{store!r}, {out!r}, {dev.type!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DP_WORLD)]
    try:
        # meanwhile, one process on the global batches
        model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
        tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
        state = create_train_state(model, tx, seed=0, device=dev)
        one, one_launches = {}, []
        for k, name in enumerate(DP_STEPS):
            mode = FP32 if name == "FP32" else QAT
            if mode is QAT and DP_STEPS[k - 1] == "FP32":
                state.start_qat()
            before = fake_quant_observe.launches
            m = make_train_step(mode, num_classes=CLASSES)(state, train_batch(k, DP_BATCH))
            one_launches.append(fake_quant_observe.launches - before)
            one.update({f"metrics/{k}/{n}": float(v) for n, v in m.items()})
        one.update({n: v.detach().cpu().numpy() for n, v in model_variables(state.model).items()})
        del state, model
        torch.cuda.empty_cache()
        logs = []
        for p in procs:
            text, _ = p.communicate(timeout=max(1.0, DP_TIMEOUT - (time.perf_counter() - t0)))
            logs.append(text)
            if p.returncode != 0:
                raise AssertionError(f"phase 22 rank failed:\n{text[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t0
    if one_launches != [0, N_SITES, N_SITES]:
        raise AssertionError(f"one-process fake_quant_observe launches {one_launches}")
    ranks = [dict(np.load(f"{out}-{r}.npz")) for r in range(DP_WORLD)]
    infos = []
    for r in range(DP_WORLD):
        with open(f"{out}-{r}.json") as f:
            infos.append(json.load(f))
    differ = [k for k in ranks[0] if not np.array_equal(ranks[0][k], ranks[1][k])]
    if differ or sorted(ranks[0]) != sorted(ranks[1]):
        raise AssertionError(f"the ranks differ at {differ[:8]} ({len(differ)} arrays)")
    mine, rep = ranks[0], {"ranks_bit_identical": True, "rank_seconds": ranks_s,
                           "backend": [ln for ln in logs[0].splitlines() if "[multihost]" in ln]}
    rel = [abs(mine[f"metrics/{k}/loss"] - one[f"metrics/{k}/loss"]) / one[f"metrics/{k}/loss"]
           for k in range(len(DP_STEPS))]
    rep["loss"] = {"dp": [float(mine[f"metrics/{k}/loss"]) for k in range(len(DP_STEPS))],
                   "one_process": [one[f"metrics/{k}/loss"] for k in range(len(DP_STEPS))],
                   "rel": rel}
    band_check("[dp] FP32 step loss, relative to one process", rel[0], FP32_LOSS_REL)
    band_check("[dp] QAT losses, worst relative to one process", max(rel[1:]), QAT_LOSS_REL)
    obs, bn_mean, bn_var = [], [], []
    for k in one:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(one[hi] - one[k]), 1e-6)
            obs.append(max(abs(float(mine[k] - one[k])), abs(float(mine[hi] - one[hi]))) / span)
        elif k.endswith("/mean"):
            v = k[:-len("mean")] + "var"
            bn_mean.append(float(np.max(np.abs(mine[k] - one[k]) / np.sqrt(one[v]))))
            bn_var.append(float(np.max(np.abs(mine[v] - one[v]) / one[v])))
    if len(obs) != N_SITES:
        raise AssertionError(f"{len(obs)} observers after the steps, expected {N_SITES}")
    rep["observer_rel_range"] = {"median": float(np.median(obs)), "worst": float(max(obs))}
    rep["bn"] = {"mean_over_std_median": float(np.median(bn_mean)),
                 "var_rel_median": float(np.median(bn_var))}
    band_check("[dp] observers, median |diff| / range", float(np.median(obs)), OBS_MEDIAN)
    band_check("[dp] observers, worst |diff| / range", float(max(obs)), OBS_WORST)
    band_check("[dp] BN running means, median |diff| / std", float(np.median(bn_mean)),
               BN_MEAN_MEDIAN)
    band_check("[dp] BN running variances, median |diff| / var", float(np.median(bn_var)),
               BN_VAR_MEDIAN)
    for r, info in enumerate(infos):
        sites = info["sites"]
        dp_sites = sum(s["route"] == "dp" for s in sites)
        if len(sites) != N_SITES or not dp_sites:
            raise AssertionError(f"rank {r}: {len(sites)} fake-quant sites checked "
                                 f"({dp_sites} on the data-parallel route), expected {N_SITES}")
        for s in info["steps"][1:]:
            c = s["launches"]
            if c["fake_quant_observe"] + c["fake_quant_dp_route"] // 2 != N_SITES or \
                    c["fake_quant_dp_route"] != 2 * dp_sites:
                raise AssertionError(f"rank {r} {s['step']} launches {c}: expected "
                                     f"{N_SITES - dp_sites} one-launch and {2 * dp_sites} "
                                     f"data-parallel route launches")
    steps = infos[0]["steps"]
    rep["steps"] = steps
    rep["sites"] = {"checked": N_SITES, "dp_route": sum(s["route"] == "dp"
                                                         for s in infos[0]["sites"]),
                    "max_abs_err": max(s["max_abs_err"] for s in infos[0]["sites"])}
    log(f"[dp] {DP_WORLD} ranks over gloo on one card, global batch {DP_BATCH}: parameters, BN "
        f"statistics and observers bit-identical between the ranks; losses "
        f"{[round(v, 6) for v in rep['loss']['dp']]} against one process "
        f"{[round(v, 6) for v in rep['loss']['one_process']]}; all {N_SITES} fake-quant "
        f"sites of the first QAT step == plain ({rep['sites']['dp_route']} on the "
        f"data-parallel route, on the all-reduced min and max); a rank's step "
        f"{', '.join(f'{s['step']} {s['ms']:.1f} ms' for s in steps)} (a correctness path: "
        f"~235 gloo collectives a step through the host); launches of a rank's QAT step "
        f"{steps[1]['launches']}")
    return rep, {f"dp {s['step'].lower()} step {i} (a rank)": s["launches"]
                 for i, s in enumerate(steps)}


def serve_dp_phase(dev):
    """Phase 22 (c): ``serve --dp 2`` with both replicas on this card:
    fused FrostNet at batch 8 and 7 (7 goes over its largest divisor that
    fits, 1), the GAN at batch 2, each bit-equal to one replica."""
    rep, launches = {}, {}
    preds = {n: Int8Predictor(MODEL, artifact=ARTIFACT, image_size=IMAGE, fuse_int8=True,
                              devices=[dev] * n) for n in (1, 2)}
    for b in (8, 7):
        x = np.random.RandomState(b).randn(b, IMAGE, IMAGE, 3).astype(np.float32)
        want = preds[1](x)
        ops.reset_launch_counts()
        got = preds[2](x)
        torch.cuda.synchronize()
        launches[f"serve dp2 fused batch {b}"] = ops.launch_counts()
        if not torch.equal(got, want):
            raise AssertionError(f"serve dp 2, batch {b}: logits != dp 1")
        rep[f"fused_bs{b}"] = {"dp1_ms": time_ms(lambda: preds[1](x), reps=10),
                               "dp2_ms": time_ms(lambda: preds[2](x), reps=10)}
    if launches["serve dp2 fused batch 8"] != DP_SERVE_LAUNCHES:
        raise AssertionError(f"dp 2 at batch 8: launches {launches['serve dp2 fused batch 8']}")
    del preds
    torch.backends.cudnn.allow_tf32 = True  # as phase 12 serves the GAN
    gans = {n: GanPredictor(GAN, artifact=GAN_ARTIFACT, image_size=GAN_IMAGE,
                            devices=[dev] * n) for n in (1, 2)}
    x = gan_images(0, 2)
    want = gans[1](x)
    ops.reset_launch_counts()
    got = gans[2](x)
    torch.cuda.synchronize()
    launches["serve dp2 gan batch 2"] = ops.launch_counts()
    torch.backends.cudnn.allow_tf32 = False
    if not torch.equal(got, want):
        raise AssertionError(f"serve dp 2, GAN batch 2: output != dp 1 (max abs diff "
                             f"{float((got - want).abs().max())})")
    log(f"[dp] serve --dp 2 on [cuda:0, cuda:0]: fused FrostNet at batch 8 and 7 and the GAN "
        f"at batch 2 bit-equal to --dp 1; launches {launches}; fused batch 8 "
        f"{rep['fused_bs8']['dp2_ms']:.3f} ms on two replicas against "
        f"{rep['fused_bs8']['dp1_ms']:.3f} ms on one (one card: no gain expected)")
    return rep, launches


def dp_trainer_cli(dev):
    """Phase 22 (d): the user's entry point, ``torchrun --nproc_per_node 2 -m
    frostnet_tpu_torch.train.classification`` with both ranks on this card
    (gloo): synthetic data, 224x224, a global batch of 64, 2 steps an epoch,
    one FP32 and one QAT epoch, the evaluations; the checkpoint, its meta
    and the metric log from rank 0 alone. Returns the epochs' images/s (the
    log's, all ranks' images; a correctness path)."""
    import re

    save = os.path.join(PHASE22_DIR, "cli")
    shutil.rmtree(save, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DP_WORLD), "-m", "frostnet_tpu_torch.train.classification", "--model", MODEL,
           "--dataset", "synthetic", "--image_size", str(IMAGE), "--batch_size", "64",
           "--steps_per_epoch", "2", "--fp_epochs", "1", "--epochs", "1", "--save_dir", save,
           "--log_every", "1", "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, GLOO_SOCKET_IFNAME="lo"),
                          capture_output=True, text=True, timeout=DP_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun classification failed:\n{(proc.stdout + proc.stderr)[-6000:]}")
    backend = [ln for ln in proc.stdout.splitlines() if "[multihost]" in ln]
    rates = {tag: float(v) for tag, v in
             re.findall(r"\[(fp_warmup|qat) 0\].*?'images_per_sec': ([0-9.]+)", proc.stdout)}
    with open(os.path.join(save, "metrics.jsonl")) as f:
        records = f.read().splitlines()
    if not backend or "gloo" not in backend[0] or set(rates) != {"fp_warmup", "qat"} or \
            "Accuracy(INT8 frozen)" not in proc.stdout:
        raise AssertionError(f"torchrun classification: unexpected log\n{proc.stdout[-4000:]}")
    for name in ("checkpoint", "best", "checkpoint_meta.json"):
        if not os.path.exists(os.path.join(save, name)):
            raise AssertionError(f"torchrun classification wrote no {name}")
    if len(records) != 4 + 1:  # one line a step and the validation, rank 0 only
        raise AssertionError(f"metrics.jsonl has {len(records)} records, expected 5 (rank 0)")
    rep = {"seconds": seconds, "backend": backend[0], "images_per_sec": rates}
    log(f"[dp] torchrun --nproc_per_node {DP_WORLD} classification.main on one card: "
        f"{backend[0].strip()}; FP32 epoch {rates['fp_warmup']:.1f} images/s, QAT epoch "
        f"{rates['qat']:.1f} (global batch 64, a correctness path); checkpoint and log from rank "
        f"0 only; {seconds:.1f} s")
    return rep


def dp_phase(dev):
    """Phase 22: (a) the native loaders, (b) the data-parallel step on two
    ranks, the route of the fake-quant kernel under data parallelism, (c)
    ``serve --dp 2``, (d) the trainer under ``torchrun``. Returns (report,
    launches of each path)."""
    rep, launches, seconds = {}, {}, {}
    for key, fn in (("native", native_phase), ("dp_step", dp_step_phase),
                    ("dp_route", dp_route_timing), ("serve_dp", serve_dp_phase),
                    ("trainer_cli", dp_trainer_cli)):
        t0 = time.perf_counter()
        got = fn(dev)
        seconds[key] = time.perf_counter() - t0
        if isinstance(got, tuple):
            rep[key], paths = got
            launches.update(paths)
        else:
            rep[key] = got
        torch.cuda.empty_cache()
    rep["seconds"] = seconds
    log(f"[dp] phase 22 in {sum(seconds.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return rep, launches


# ---------------------------------------------------------------------------
# Phase 23: the last configurations
# ---------------------------------------------------------------------------

PHASE23_DIR = os.path.join(ROOT, "build", "phase23")
P23_WORLD = 2
P23_TIMEOUT = 240  # seconds a group of ranks may take, their start included
# the trainers under torchrun on this card: full width, 2 steps a phase
P23_TRAINERS = {
    "seg": ("segmentation", dict(SEG_TRAINER_CFG)),
    "det": ("detection", dict(DET_TRAINER_CFG)),
    "pix2pix": ("gan", dict(GAN_TRAINER_CFG, batch_size=2, epochs=1)),
    "cyclegan": ("gan", dict(GAN_TRAINER_CFG, model="cycle_gan", batch_size=2, epochs=1)),
    "gan_batch1": ("gan", dict(GAN_TRAINER_CFG, batch_size=1, epochs=1)),
}
# the trainers' bands against the one process on the same global batches:
# phase 17's and 18's (phase 8's), phase 19's for the GANs. The phase turns
# TF32 off itself: cuDNN's TF32 (on by default) in the one-process run put
# det's first step 2.25e-4 off when the phase ran without the script's
# settings, and 0-9.4e-8 off with them
P23_BANDS = {"seg": (FP32_LOSS_REL, QAT_LOSS_REL), "det": (FP32_LOSS_REL, QAT_LOSS_REL)}
# (b) tensor parallelism: (world, mp) of each layout; the global batch (a
# rank's step is bound by gloo's host round trips: 16 rows took 2-3 s more)
P23_MP_LAYOUTS = {"mp2": (2, 2), "dp2xmp2": (4, 2), "dp2": (2, 1)}
P23_MP_BATCH = 8
# test_multihost's bands (printed; the CPU test of the port holds them at
# its settings); phase 22's decide on the card
MP_LOSS_RTOL, MP_LOGITS_ATOL, MP_LEAF_ATOL = 1e-6, 1e-5, 1e-4
# each parameter's update in the FP32 step against the reference's,
# ||d mine - d ref|| / ||d ref||, the median and the worst over the
# parameters: read 0.0037-0.0066 and 0.028-0.035 on the card at a global
# batch of 16, 0.0055-0.0062 and 0.031-0.032 at 8 (mp 2 against one
# process, dp 2 x mp 2 against dp 2 x mp 1; dp 2 against one process, no
# mp, alike); a lost mp gradient sum reads 0.90 in the median (the CPU
# test's model). The QAT step's gap, printed, reads 0.94-0.97 in
# the median between any two sum orders, dp 2 against one process too, and
# 0 between two runs of one process: it cannot tell a wrong gradient
MP_FP32_UPDATE_GAP = (0.02, 0.15)
# (c) remat: phase 10's step at batch 256
P23_REMAT_BATCH = 256
# (d) the INT8 routes the port once refused: (name, cin, cout, kernel, stride,
# padding, dilation, groups, act, hw)
P23_ROUTES = [("padded 1x1", 64, 128, 1, 1, 1, 1, 1, "relu", 56),
              ("padded 1x1 stride 2", 96, 192, 1, 2, (1, 0), 1, 1, None, 56),
              ("dilated grouped 3x3", 128, 128, 3, 1, 2, 2, 32, "relu", 28),
              ("depthwise 3x5", 96, 96, (3, 5), 1, (1, 2), 1, 96, "relu", 56),
              ("depthwise valid 5x5 stride 2", 144, 144, 5, 2, 0, 1, 144, None, 57)]
P23_ROUTE_BATCH = 8


def _gan_cfg(kw):
    return {k: v for k, v in kw.items() if k != "device"}


class FirstQatCheck:
    """Patches a trainer module's step factories for a run: the first call
    of each step function the QAT phase makes runs with every fake-quant
    site held against its plain version (``_DPSiteCheck``: the
    data-parallel route at the activation sites, on the all-reduced min and
    max)."""

    def __init__(self, module, names, record):
        self.mod, self.names, self.record = module, names, record
        self.saved = {n: getattr(module, n) for n in names}

    def _step(self, fn):
        done = []

        def run(*args, **kwargs):
            if done:
                return fn(*args, **kwargs)
            done.append(1)
            _DPSiteCheck.record = self.record
            quant_ops.ObservedFakeQuant = _DPSiteCheck
            try:
                return fn(*args, **kwargs)
            finally:
                quant_ops.ObservedFakeQuant = ObservedFakeQuant
        return run

    def _factory(self, make):
        def factory(mode, *args, **kwargs):
            out = make(mode, *args, **kwargs)
            if mode is not QAT:
                return out
            return tuple(self._step(f) for f in out) if isinstance(out, tuple) else self._step(out)
        return factory

    def __enter__(self):
        for n, make in self.saved.items():
            setattr(self.mod, n, self._factory(make))
        return self

    def __exit__(self, *exc):
        for n, make in self.saved.items():
            setattr(self.mod, n, make)


def p23_run_trainer(kind: str, save_dir: str, device: str, record=None):
    """``main`` of the trainer ``kind`` of ``P23_TRAINERS`` into ``save_dir``:
    its record (every final variable under ``<net>/<key>``, the FP32
    warm-up's losses under ``fp32/<i>``, the QAT phase's under ``qat/<i>``),
    None on an idle rank. With ``record`` (a list) the first QAT step's
    fake-quant sites are checked into it."""
    from frostnet_tpu_torch.detection import train as det_train
    from frostnet_tpu_torch.gan import train as gan_train
    from frostnet_tpu_torch.segmentation import train as seg_train

    pkg, kw = P23_TRAINERS[kind]
    if pkg == "segmentation":
        mod, names = seg_train, ("make_seg_train_step",)
    elif pkg == "detection":
        mod, names = det_train, ("make_det_train_step",)
    else:
        mod, names = gan_train, ("make_pix2pix_steps", "make_cyclegan_steps")
    check = FirstQatCheck(mod, names, record) if record is not None else contextlib.nullcontext()
    with check:
        if pkg == "segmentation":
            state, res = seg_train.main(seg_train.SegConfig(save_dir=save_dir, device=device,
                                                            **kw))
            nets = {"net": state.model}
            losses = [(h["tag"], v) for h in res["history"] for v in h["losses"]]
        elif pkg == "detection":
            state, res = det_train.main(det_train.DetConfig(save_dir=save_dir, device=device,
                                                            **kw))
            if state is None:
                return None
            nets = {"net": state.model}
            losses = [(h["tag"], h["loss"]) for h in res["history"]]
        else:
            gs, ds, res = gan_train.main(gan_train.GANConfig(save_dir=save_dir, device=device,
                                                             **_gan_cfg(kw)))
            if res.get("idle"):
                return None
            nets = {f"g{i}": s.model for i, s in enumerate(gs)}
            nets.update({f"d{i}": s.model for i, s in enumerate(ds)})
            losses = [(r["tag"], v) for r in res["history"] for k in sorted(r["losses"])
                      for v in r["losses"][k]]
    rec = {}
    for name, model in nets.items():
        rec.update({f"{name}/{k}": v.detach().cpu().numpy()
                    for k, v in model_variables(model).items()})
    for phase in ("fp32", "qat"):
        mine = [float(v) for tag, v in losses if (tag == "fp_warmup") == (phase == "fp32")]
        rec.update({f"{phase}/{i}": v for i, v in enumerate(mine)})
    return rec


def p23_trainer_rank(kind: str, out: str, device: str = "cuda"):
    """A rank of ``torchrun --nproc_per_node 2 chip_smoke.py --p23-trainer
    kind``: the trainer's ``main`` under torchrun's process group (gloo on
    one card), the first QAT step's sites checked; writes its record to
    ``out/kind-rank.npz`` (not on an idle rank) and its launches, sites and
    seconds to ``out/kind-rank.json``."""
    import torch.distributed as dist

    from frostnet_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(device)
    rank = dist.get_rank()
    dev = multihost.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sites = []
    ops.reset_launch_counts()
    fake_quant_observe.dp_launches = 0
    t0 = time.perf_counter()
    rec = p23_run_trainer(kind, os.path.join(out, kind, "dp"), device, sites)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    counts["fake_quant_dp_route"] = fake_quant_observe.dp_launches
    if rec is not None:
        np.savez(os.path.join(out, f"{kind}-{rank}.npz"), **rec)
    with open(os.path.join(out, f"{kind}-{rank}.json"), "w") as f:
        json.dump({"launches": counts, "sites": sites, "idle": rec is None,
                   "seconds": time.perf_counter() - t0}, f)
    return 0


def _state_bands(mine, ref):
    """(each observer's |diff| / its range, each BN's max |d mean| / std,
    each BN's max |d var| / var) of the variables ``mine`` against ``ref``
    (flat keys): phase 8's measures."""
    obs, means, variances = [], [], []
    for k in ref:
        if k.endswith(".min_val") and np.isfinite(ref[k]).all():
            hi = k.replace(".min_val", ".max_val")
            span = max(float(np.max(ref[hi] - ref[k])), 1e-6)
            obs.append(max(float(np.max(np.abs(mine[k] - ref[k]))),
                           float(np.max(np.abs(mine[hi] - ref[hi])))) / span)
        elif k.endswith("/mean"):
            var = ref[k[:-len("mean")] + "var"]
            means.append(float(np.max(np.abs(mine[k] - ref[k]) / np.sqrt(var))))
        elif k.endswith("/var"):
            variances.append(float(np.max(np.abs(mine[k] - ref[k]) / ref[k])))
    return obs, means, variances


def _p23_bands(kind, mine, ref):
    """The two ranks' run against the one process on the same global
    batches: the loss bands of the trainer's phase, the observers' and BN's
    bands of phase 8. Returns the measured values."""
    fp32_band, qat_band = P23_BANDS.get(kind, (GAN_FP32_LOSS_REL, GAN_QAT_LOSS_REL))
    rep = {}
    # the first step starts from the same weights: only the BN sums' order
    # differs; every later one carries the first's differences (a channel
    # of near-zero variance amplifies them, as in QAT), phase 22's rule
    keys = [k for k in ref if k.startswith(("fp32/", "qat/"))]
    rel = {k: abs(float(mine[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-12)
           for k in keys}
    first = "fp32/0"
    later = [v for k, v in rel.items() if k != first]
    if first not in rel or rel[first] > fp32_band or not later or max(later) > qat_band:
        raise AssertionError(f"[p23] {kind} losses {rel} outside the bands {fp32_band} (the "
                             f"first step) and {qat_band}")
    rep["fp32_loss_rel"], rep["qat_loss_rel"] = rel[first], max(later)
    obs, means, variances = _state_bands(mine, ref)
    if obs:
        band_check(f"[p23] {kind}: observers, median |diff| / range", float(np.median(obs)),
                   OBS_MEDIAN)
        band_check(f"[p23] {kind}: observers, worst |diff| / range", float(max(obs)), OBS_WORST)
        rep["observer_rel_range"] = {"median": float(np.median(obs)), "worst": float(max(obs))}
    band_check(f"[p23] {kind}: BN running means, median |diff| / std", float(np.median(means)),
               BN_MEAN_MEDIAN)
    band_check(f"[p23] {kind}: BN running variances, median |diff| / var",
               float(np.median(variances)), BN_VAR_MEDIAN)
    rep["bn"] = {"mean_over_std_median": float(np.median(means)),
                 "var_rel_median": float(np.median(variances))}
    return rep


def p23_trainers(dev, launches):
    """Phase 23 (a): each trainer under ``torchrun --nproc_per_node 2`` on
    this card (gloo), all started together; meanwhile each runs in this
    process on the same global batches. Each two-rank run exits 0, keeps
    its ranks bit-identical, writes its save directory from rank 0 alone,
    stays within its bands of the one process, and holds every fake-quant
    site of its first QAT step to the plain version; at batch 1 rank 1
    idles."""
    out = PHASE23_DIR
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = {kind: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(P23_WORLD), os.path.join(ROOT, "chip_smoke.py"), "--p23-trainer", kind,
         "--p23-dir", out, "--p23-device", dev.type],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind in P23_TRAINERS}
    one, one_s = {}, {}
    try:
        for kind in P23_TRAINERS:
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            one[kind] = p23_run_trainer(kind, os.path.join(out, kind, "one"), dev.type)
            one_s[kind] = time.perf_counter() - t1
            torch.cuda.empty_cache()
        logs = {}
        for kind, p in procs.items():
            text, _ = p.communicate(timeout=max(1.0, P23_TIMEOUT - (time.perf_counter() - t0)))
            logs[kind] = text
            if p.returncode != 0:
                raise AssertionError(f"[p23] torchrun {kind} failed:\n{text[-6000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    rep = {"seconds": time.perf_counter() - t0, "one_process_s": one_s, "runs": {}}
    errors = []
    for kind in P23_TRAINERS:
        try:
            rep["runs"][kind] = _p23_trainer_checks(kind, out, logs, one, launches)
        except AssertionError as e:
            errors.append(str(e))
            log(f"[p23] {kind}: FAILED: {e}")
    if errors:
        raise AssertionError("; ".join(errors))
    return rep


def _p23_trainer_checks(kind, out, logs, one, launches):
    """The checks of phase 23 (a) on the trainer ``kind``'s two-rank run."""
    infos = []
    for r in range(P23_WORLD):
        with open(os.path.join(out, f"{kind}-{r}.json")) as f:
            infos.append(json.load(f))
    run = {"rank_seconds": [i["seconds"] for i in infos],
           "launches": [i["launches"] for i in infos]}
    dp_dir, one_dir = os.path.join(out, kind, "dp"), os.path.join(out, kind, "one")
    if sorted(os.listdir(dp_dir)) != sorted(os.listdir(one_dir)):
        raise AssertionError(f"[p23] {kind}: wrote {sorted(os.listdir(dp_dir))}, one "
                             f"process {sorted(os.listdir(one_dir))}")
    lines = [len(open(os.path.join(d, "metrics.jsonl")).read().splitlines())
             for d in (dp_dir, one_dir)]
    if lines[0] != lines[1]:
        raise AssertionError(f"[p23] {kind}: metrics.jsonl has {lines[0]} records, one "
                             f"process {lines[1]}: not rank 0 alone")
    if kind == "gan_batch1":
        if not infos[1]["idle"] or infos[0]["idle"] or \
                os.path.exists(os.path.join(out, f"{kind}-1.npz")):
            raise AssertionError("[p23] gan batch 1: rank 1 should idle (dp 1)")
        if "mesh {'dp': 1, 'mp': 1}" not in logs[kind]:
            raise AssertionError(f"[p23] gan batch 1: no dp-1 mesh in the log")
        mine = dict(np.load(os.path.join(out, f"{kind}-0.npz")))
    else:
        ranks = [dict(np.load(os.path.join(out, f"{kind}-{r}.npz")))
                 for r in range(P23_WORLD)]
        differ = [k for k in ranks[0] if not np.array_equal(ranks[0][k], ranks[1][k])]
        if differ or sorted(ranks[0]) != sorted(ranks[1]):
            raise AssertionError(f"[p23] {kind}: the ranks differ at {differ[:8]}")
        mine = ranks[0]
        if "backend gloo" not in logs[kind]:
            raise AssertionError(f"[p23] {kind}: not on gloo:\n{logs[kind][-3000:]}")
    run.update(_p23_bands(kind, mine, one[kind]))
    sites = infos[0]["sites"]
    if not sites:
        raise AssertionError(f"[p23] {kind}: no fake-quant site checked")
    run["sites"] = {"checked": len(sites), "dp_route": sum(s["route"] == "dp" for s in sites),
                    "max_abs_err": max(s["max_abs_err"] for s in sites)}
    for r, info in enumerate(infos):
        launches[f"p23 torchrun {kind} rank {r}"] = info["launches"]
    log(f"[p23] torchrun {kind} on 2 ranks: ranks bit-identical"
        f"{' (rank 1 idle: dp 1)' if kind == 'gan_batch1' else ''}, rank 0 wrote alone, "
        f"losses within {run['fp32_loss_rel']:.3g} (the first step) and "
        f"{run['qat_loss_rel']:.3g} (the later ones) of one process; "
        f"{run['sites']['checked']} fake-quant sites of the first QAT step == plain "
        f"({run['sites']['dp_route']} on the data-parallel route); rank "
        f"0 {run['rank_seconds'][0]:.1f} s; launches of rank 0 {run['launches'][0]}")
    return run


def p23_mp_state(dev, warm: str):
    """A state of phase 8's model and optimizer (float32, GradBoost noise
    off, drop_rate 0) on ``dev`` from the warm variables in ``warm``, in
    QAT."""
    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(model, tx, seed=0, device=dev,
                               variables=unflatten_variables(dict(np.load(warm))))
    return state.start_qat()


def p23_mp_rank(rank: int, world: int, mp: int, store: str, out: str, warm: str,
                device: str = "cuda"):
    """One rank of phase 23 (b), in its own process on ``cuda:0``: from the
    warm state (``p23_mp_state``), ``shard_params_for_mp`` on a ``mp > 1``
    mesh, one QAT step (every fake-quant site checked) and a QAT_FROZEN
    forward on this rank's rows of ``train_batch(k, P23_MP_BATCH)``, then
    the FP32 step from the warm state. Writes the losses, the logits and the
    gathered variables to ``out``-rank.npz (the FP32 step's under
    ``fp32/``), the launches to .json."""
    from frostnet_tpu_torch.parallel import (data_parallel, gather_mp, make_mesh, multihost,
                                             shard_batch, shard_params_for_mp)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(device, init_method=f"file://{store}", rank=rank, world_size=world)
    dev = multihost.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(mp=mp)
    deadline = time.perf_counter() + P23_TIMEOUT
    while not os.path.exists(warm):  # written by p23_mp_start meanwhile
        if time.perf_counter() > deadline:
            raise TimeoutError(f"no warm state at {warm}")
        time.sleep(0.05)
    state = p23_mp_state(dev, warm)
    sharded = shard_params_for_mp(state.model, mesh)
    rec, info, sites = {}, {"sharded": len(sharded)}, []
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    fake_quant_observe.dp_launches = 0
    _DPSiteCheck.record = sites
    quant_ops.ObservedFakeQuant = _DPSiteCheck
    try:
        m = make_train_step(QAT, num_classes=CLASSES, mesh=mesh)(
            state, shard_batch(train_batch(1, P23_MP_BATCH), mesh))
    finally:
        quant_ops.ObservedFakeQuant = ObservedFakeQuant
    rec["loss"] = float(m["loss"])
    with torch.no_grad(), data_parallel(mesh):
        image = prep_image(torch.as_tensor(shard_batch(train_batch(2, P23_MP_BATCH), mesh)
                                           ["image"]).to(dev))
        rec["logits"] = state.model(image, mode=QAT_FROZEN).cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    info["seconds"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    counts["fake_quant_dp_route"] = fake_quant_observe.dp_launches
    info["launches"], info["sites"] = counts, len(sites)
    info["dp_route_sites"] = sum(s["route"] == "dp" for s in sites)
    with gather_mp(state.model):
        rec.update({k: v.detach().cpu().numpy() for k, v in model_variables(state.model).items()})
    # the same step in FP32 (no fake-quant code to move): the gradients'
    # check, free of the codes a partial sum's order moves
    state = p23_mp_state(dev, warm)
    shard_params_for_mp(state.model, mesh)
    m = make_train_step(FP32, num_classes=CLASSES, mesh=mesh)(
        state, shard_batch(train_batch(1, P23_MP_BATCH), mesh))
    rec["fp32/loss"] = float(m["loss"])
    with gather_mp(state.model):
        rec.update({f"fp32/{k}": v.detach().cpu().numpy()
                    for k, v in model_variables(state.model).items()})
    np.savez(f"{out}-{rank}.npz", **rec)
    with open(f"{out}-{rank}.json", "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


def _update_gaps(mine, ref, warm):
    """Each parameter's update against the reference's, both from ``warm``:
    {key: ||d mine - d ref|| / ||d ref||}, d the change from ``warm``. A
    parameter whose reference update is under 1e-3 of the median's (per
    element) is left out: its exact gradient is zero (a BN shift that a
    later BN removes) and its update rounding."""
    steps = {}
    for k, a in ref.items():
        if k.startswith("params/"):
            d = a.astype(np.float64) - warm[k]
            steps[k] = (d, float(np.linalg.norm(d) / np.sqrt(d.size)))
    floor = 1e-3 * float(np.median([rms for _, rms in steps.values()]))
    return {k: float(np.linalg.norm(mine[k].astype(np.float64) - warm[k] - d)
                     / np.linalg.norm(d)) for k, (d, rms) in steps.items() if rms > floor}


def _mp_steps(rec):
    """A phase 23 (b) record split into its QAT step's and its FP32 step's."""
    return ({k: v for k, v in rec.items() if not k.startswith("fp32/")},
            {k[len("fp32/"):]: v for k, v in rec.items() if k.startswith("fp32/")})


def _gap_report(gaps):
    worst = max(gaps, key=gaps.get)
    return {"median": float(np.median(list(gaps.values()))), "worst": gaps[worst],
            "variable": worst, "count": len(gaps)}


def _mp_compare(what, mine, ref, logits, warm):
    """``mine`` (a rank's record) against ``ref``, both a QAT step and an
    FP32 step (keys under ``fp32/``) from the variables ``warm``:
    test_multihost's measures (the loss, the QAT_FROZEN logits of the
    global batch ``logits``, each variable scaled by max(|v|, 1)) printed
    against its bands, and phase 22's bands for a comparison of two layouts
    on the card (the loss in the QAT band, the observers and BN statistics
    in phase 8's), which must hold: at full width a one-ulp change of a
    partial sum moves a fake-quant code here and there, and the QAT_FROZEN
    forward carries it. Each parameter's update (its change from ``warm``)
    against the reference's, ||d mine - d ref|| / ||d ref||: in the FP32
    step within ``MP_FP32_UPDATE_GAP`` (no code moves there: a dropped or
    doubled tensor-parallel gradient moves a layer's by 0.5 or more); in the
    QAT step printed."""
    (mine, fp32), (ref, fp32_ref) = _mp_steps(mine), _mp_steps(ref)
    rep = {"loss_rel": abs(mine["loss"] - ref["loss"]) / abs(ref["loss"]),
           "logits_max_abs": float(np.abs(logits - ref["logits"]).max()),
           "logits_rel_l2": float(np.linalg.norm(logits - ref["logits"])
                                  / np.linalg.norm(ref["logits"])),
           "fp32_loss_rel": abs(fp32["loss"] - fp32_ref["loss"]) / abs(fp32_ref["loss"]),
           "update_gap_qat": _gap_report(_update_gaps(mine, ref, warm)),
           "update_gap_fp32": _gap_report(_update_gaps(fp32, fp32_ref, warm))}
    worst = (0.0, "")
    for k, a in ref.items():
        if k in ("loss", "logits") or not a.size:
            continue
        scale = max(float(np.abs(a).max()), 1.0)
        worst = max(worst, (float(np.abs(a / scale - mine[k] / scale).max()), k))
    obs, means, variances = _state_bands(mine, ref)
    rep["leaf_worst"] = {"value": worst[0], "variable": worst[1]}
    rep["jax_bands_hold"] = bool(rep["loss_rel"] <= MP_LOSS_RTOL
                                 and rep["logits_max_abs"] <= MP_LOGITS_ATOL
                                 and worst[0] <= MP_LEAF_ATOL)
    rep["observer_rel_range"] = {"median": float(np.median(obs)), "worst": float(max(obs))}
    rep["bn"] = {"mean_over_std_median": float(np.median(means)),
                 "var_rel_median": float(np.median(variances))}
    log(f"[p23] {what}: loss rel {rep['loss_rel']:.3g} (FP32 step {rep['fp32_loss_rel']:.3g}), "
        f"QAT_FROZEN logits max |diff| "
        f"{rep['logits_max_abs']:.3g} (rel L2 {rep['logits_rel_l2']:.3g}), worst variable "
        f"{worst[0]:.3g} ({worst[1]}); test_multihost's bands ({MP_LOSS_RTOL:g}, "
        f"{MP_LOGITS_ATOL:g}, {MP_LEAF_ATOL:g}) {'hold' if rep['jax_bands_hold'] else 'missed'}")
    for step in ("fp32", "qat"):
        g = rep[f"update_gap_{step}"]
        log(f"[p23] {what}: the {g['count']} parameters' updates of the {step.upper()} step "
            f"against the reference's, ||d mine - d ref|| / ||d ref||: median {g['median']:.3g}, "
            f"worst {g['worst']:.3g} ({g['variable']})")
    band_check(f"[p23] {what}: QAT loss, relative", rep["loss_rel"], QAT_LOSS_REL)
    band_check(f"[p23] {what}: FP32 loss, relative", rep["fp32_loss_rel"], FP32_LOSS_REL)
    band_check(f"[p23] {what}: FP32 step's parameter updates, median gap",
               rep["update_gap_fp32"]["median"], MP_FP32_UPDATE_GAP[0])
    band_check(f"[p23] {what}: FP32 step's parameter updates, worst gap",
               rep["update_gap_fp32"]["worst"], MP_FP32_UPDATE_GAP[1])
    band_check(f"[p23] {what}: observers, median |diff| / range",
               rep["observer_rel_range"]["median"], OBS_MEDIAN)
    band_check(f"[p23] {what}: observers, worst |diff| / range",
               rep["observer_rel_range"]["worst"], OBS_WORST)
    band_check(f"[p23] {what}: BN running means, median |diff| / std",
               rep["bn"]["mean_over_std_median"], BN_MEAN_MEDIAN)
    band_check(f"[p23] {what}: BN running variances, median |diff| / var",
               rep["bn"]["var_rel_median"], BN_VAR_MEDIAN)
    if not np.isfinite(logits).all():
        raise AssertionError(f"[p23] {what}: non-finite logits")
    return rep


def p23_mp_start(dev):
    """Phase 23 (b)'s start: the ranks of every layout started
    (``p23_mp_rank``), and meanwhile ``frostnet_quant_large_1_0`` at
    224x224 warmed in this process (an FP32 step and four QAT steps:
    test_multihost's warm start, so that no BN channel of near-zero variance
    amplifies a float-sum order), which they wait for. Returns what
    :func:`p23_mp` waits for."""
    out = os.path.join(PHASE23_DIR, "mp")
    os.makedirs(out, exist_ok=True)
    warm = os.path.join(out, "warm.npz")
    t0 = time.perf_counter()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = []  # started first: they wait for the warm state while they start
    for name, (world, mp) in P23_MP_LAYOUTS.items():
        store = os.path.join(out, f"{name}.store")
        procs += [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.p23_mp_rank({r}, {world}, "
                                   f"{mp}, {store!r}, {os.path.join(out, name)!r}, {warm!r}, "
                                   f"{dev.type!r})"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(model, tx, seed=0, device=dev)
    for k in range(5):
        if k == 1:
            state.start_qat()
        make_train_step(FP32 if k == 0 else QAT, num_classes=CLASSES)(
            state, train_batch(10 + k, P23_MP_BATCH))
    np.savez(warm + ".part.npz", **{k: v.detach().cpu().numpy()
                                    for k, v in model_variables(state.model).items()})
    os.replace(warm + ".part.npz", warm)
    del state, model
    torch.cuda.empty_cache()
    return {"out": out, "warm": warm, "procs": procs, "t0": t0}


def p23_mp_one_process(dev, warm: str) -> dict:
    """Phase 23 (b) in one process: the QAT step from the warm state, the
    QAT_FROZEN forward, then the FP32 step from the warm state (keys under
    ``fp32/``), as :func:`p23_mp_rank` records them."""
    state = p23_mp_state(dev, warm)
    rec = {"loss": float(make_train_step(QAT, num_classes=CLASSES)(
        state, train_batch(1, P23_MP_BATCH))["loss"])}
    with torch.no_grad():
        image = prep_image(torch.as_tensor(train_batch(2, P23_MP_BATCH)["image"]).to(dev))
        rec["logits"] = state.model(image, mode=QAT_FROZEN).cpu().numpy()
    rec.update({k: v.detach().cpu().numpy() for k, v in model_variables(state.model).items()})
    state = p23_mp_state(dev, warm)
    rec["fp32/loss"] = float(make_train_step(FP32, num_classes=CLASSES)(
        state, train_batch(1, P23_MP_BATCH))["loss"])
    rec.update({f"fp32/{k}": v.detach().cpu().numpy()
                for k, v in model_variables(state.model).items()})
    del state
    torch.cuda.empty_cache()
    return rec


def p23_mp(dev, launches):
    """Phase 23 (b): one QAT step and a QAT_FROZEN forward, and one FP32
    step, from the warm state on mp 2 (two ranks), dp 2 x mp 2 (four) and
    dp 2 x mp 1 (two), all on this card over gloo (:func:`p23_mp_start`),
    and in this process (twice: the control of the card's nondeterminism):
    mp 2 against the one process and dp 2 x mp 2 against dp 2 x mp 1 (the
    same rows a rank: the same BN sums) in :func:`_mp_compare`'s bands, dp
    2 against the one process printed beside them; the ranks of a layout
    hold the same gathered variables."""
    job = p23_mp_start(dev)
    out, warm, procs, t0 = job["out"], job["warm"], job["procs"], job["t0"]
    try:
        # twice: the second is the control of what the card's nondeterminism
        # alone moves
        one, again = (p23_mp_one_process(dev, warm) for _ in range(2))
        for p in procs:
            text, _ = p.communicate(timeout=max(1.0, P23_TIMEOUT - (time.perf_counter() - t0)))
            if p.returncode != 0:
                raise AssertionError(f"[p23] mp rank failed:\n{text[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rep = {"seconds": time.perf_counter() - t0}
    recs, infos = {}, {}
    for name, (world, mp) in P23_MP_LAYOUTS.items():
        recs[name] = [dict(np.load(os.path.join(out, f"{name}-{r}.npz"))) for r in range(world)]
        infos[name] = []
        for r in range(world):
            with open(os.path.join(out, f"{name}-{r}.json")) as f:
                infos[name].append(json.load(f))
            launches[f"p23 {name} rank {r}"] = infos[name][-1]["launches"]
        for r in range(1, world):
            for k, v in recs[name][0].items():
                if k == "logits" and r // mp:
                    continue
                if not np.array_equal(v, recs[name][r][k]):
                    raise AssertionError(f"[p23] {name}: rank {r} differs from rank 0 at {k}")
    logits = {name: np.concatenate([recs[name][r]["logits"] for r in range(0, world, mp)])
              for name, (world, mp) in P23_MP_LAYOUTS.items()}
    rep["ranks"] = {name: [{k: i[k] for k in ("seconds", "launches", "sites", "dp_route_sites",
                                              "sharded")} for i in info]
                    for name, info in infos.items()}
    for name, info in infos.items():
        if any(i["sites"] != N_SITES for i in info):
            raise AssertionError(f"[p23] {name}: {[i['sites'] for i in info]} fake-quant sites "
                                 f"checked, expected {N_SITES}")
    log(f"[p23] mp: {infos['mp2'][0]['sharded']} kernels sharded on mp 2; every rank's "
        f"{N_SITES} fake-quant sites of the QAT step == plain; a rank's QAT step and forward: "
        + ", ".join(f"{n} {info[0]['seconds']:.1f} s" for n, info in infos.items())
        + "; launches of rank 0: " + ", ".join(f"{n} {info[0]['launches']}"
                                               for n, info in infos.items()))
    warm = dict(np.load(warm))
    controls = {"one_process_twice": (again, one), "dp2_vs_one_process": (recs["dp2"][0], one)}
    for name, (a, b) in controls.items():
        (a_qat, a_fp32), (b_qat, b_fp32) = _mp_steps(a), _mp_steps(b)
        rep[name] = {"fp32": _gap_report(_update_gaps(a_fp32, b_fp32, warm)),
                     "qat": _gap_report(_update_gaps(a_qat, b_qat, warm))}
        log(f"[p23] {name}: parameter updates, ||d mine - d ref|| / ||d ref||: " + "; ".join(
            f"{step.upper()} median {g['median']:.3g}, worst {g['worst']:.3g} ({g['variable']})"
            for step, g in rep[name].items()))
    rep["mp2_vs_one_process"] = _mp_compare("mp 2 (2 ranks) against one process",
                                            recs["mp2"][0], one, logits["mp2"], warm)
    ref = dict(recs["dp2"][0], logits=logits["dp2"])
    rep["dp2xmp2_vs_dp2"] = _mp_compare("dp 2 x mp 2 (4 ranks) against dp 2 x mp 1",
                                        recs["dp2xmp2"][0], ref, logits["dp2xmp2"], warm)
    return rep


def p23_remat(dev, launches):
    """Phase 23 (c): phase 10's QAT step (bf16, bench.py's optimizer) at batch
    256, plain, ``remat="full"`` and ``"conv_outs"``, each from the same
    state with ``cudnn.deterministic``: the first step's loss and every
    variable against plain, then its peak memory and ms a step."""
    rep = {}
    torch.backends.cudnn.deterministic = True
    try:
        base = None
        for remat in (False, "full", "conv_outs"):
            model = create_model(MODEL, num_classes=CLASSES, dtype=torch.bfloat16)
            tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5))
            state = create_train_state(model, tx, seed=0, device=dev)
            state.start_qat()
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in train_batch(0, P23_REMAT_BATCH).items()}
            step = make_train_step(QAT, num_classes=CLASSES, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            loss = float(step(state, batch)["loss"])
            torch.cuda.synchronize()
            name = str(remat) if remat else "plain"
            launches[f"p23 remat {name} step"] = ops.launch_counts()
            row = {"loss": loss, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            flat = {k: v.detach().float().cpu().numpy().copy() for k, v in
                    model_variables(state.model).items()}
            if base is None:
                base = (loss, flat)
            else:
                differ = [k for k in flat
                          if not np.array_equal(flat[k], base[1][k], equal_nan=True)]
                row["loss_equal"] = loss == base[0]
                row["variables_differing"] = len(differ)
                row["max_abs_diff"] = max([float(np.nanmax(np.abs(flat[k] - base[1][k])))
                                           for k in differ] or [0.0])
            row["ms_per_step"] = time_ms(lambda: step(state, batch), reps=3, warmup=1)
            rep[name] = row
            del state, model, batch, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    for name in ("full", "conv_outs"):
        r = rep[name]
        if not r["loss_equal"] or r["variables_differing"]:
            raise AssertionError(
                f"[p23] remat {name}: the step differs from plain under cudnn.deterministic: "
                f"loss equal {r['loss_equal']}, {r['variables_differing']} variables differ, "
                f"max |diff| {r['max_abs_diff']:.3g}")
    log(f"[p23] remat at batch {P23_REMAT_BATCH} (bf16 QAT step): " + "; ".join(
        f"{n} {r['ms_per_step']:.1f} ms/step, peak {r['peak_gib']:.2f} GiB"
        + ("" if n == "plain" else f", == plain: loss {r['loss_equal']}, "
           f"{r['variables_differing']} variables differ")
        for n, r in rep.items()))
    return rep


def _route_layer(cfg, device):
    """A QConvBNAct of ``P23_ROUTES`` with seeded variables, its observers
    calibrated by two QAT eval forwards, frozen on ``device`` for inputs on
    grid (0.027, 97); the codes of a batch."""
    name, cin, cout, k, s, p, d, g, act, hw = cfg
    layer = QConvBNAct(cin, cout, k, strides=s, padding=p, dilation=d, groups=g, act=act)
    rng = np.random.RandomState(len(name))
    with torch.no_grad():
        kern = layer.kernel
        fan = int(np.prod(kern.shape[:-1]))
        kern.copy_(torch.as_tensor(rng.randn(*kern.shape).astype(np.float32)
                                   * np.sqrt(2.0 / fan)))
        layer.scale.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, cout).astype(np.float32)))
        layer.bias_bn.copy_(torch.as_tensor(rng.normal(0.2, 0.3, cout).astype(np.float32)))
        layer.mean.copy_(torch.as_tensor(rng.normal(0, 0.1, cout).astype(np.float32)))
        layer.var.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, cout).astype(np.float32)))
    grid = QParams(0.027, 97)
    q = torch.as_tensor(rng.randint(0, 256, (P23_ROUTE_BATCH, hw, hw, cin)).astype(np.uint8))
    xf = (q.float() - grid.zero_point) * torch.tensor(grid.scale, dtype=torch.float32)
    with torch.no_grad():
        for _ in range(2):
            layer(xf, mode=QAT, train=False)
    layer.eval()
    layer.prepare_int8(grid, device)
    return layer, QTensor(q.to(device), *grid.tensors(device))


def p23_routes(dev, launches):
    """Phase 23 (d): the INT8 routes the port once refused, on the card
    against the plain version on the CPU (the same layer frozen on each):
    the padded 1x1's matmul kernel, the depthwise kernel and the grouped
    route's torch ops, codes bit-equal."""
    rep = {}
    for cfg in P23_ROUTES:
        layer, x = _route_layer(cfg, dev)
        ops.reset_launch_counts()
        got = layer(x, mode=INT8).q
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        plain, xc = _route_layer(cfg, torch.device("cpu"))
        want = plain(xc, mode=INT8).q
        err = check_equal(f"[p23] route {cfg[0]} ({layer._route})", got.cpu(), want)
        rep[cfg[0]] = {"route": layer._route, "shape": list(got.shape), "launches": counts,
                       "max_abs_err": err, "distinct_codes": int(len(torch.unique(want)))}
        launches[f"p23 route {cfg[0]}"] = counts
    if rep["padded 1x1"]["launches"]["int8_matmul_requant"] != 1:
        raise AssertionError(f"[p23] the padded 1x1 launched {rep['padded 1x1']['launches']}")
    for name, r in rep.items():
        if r["route"] == "depthwise" and r["launches"]["depthwise_int8"] != 1:
            raise AssertionError(f"[p23] the {name} launched {r['launches']}")
    log(f"[p23] INT8 routes on the card == plain, codes bit for bit: "
        + "; ".join(f"{n} ({r['route']}, {r['shape']}, {r['distinct_codes']} codes)"
                    for n, r in rep.items()))
    return rep


def last_configs_phase(dev):
    """Phase 23: (a) the seg, det and GAN trainers on two ranks, (b) mp 2 and
    dp 2 x mp 2, (c) remat, (d) the INT8 routes once refused. Returns
    (report, launches of each path)."""
    rep, launches, seconds, errors = {}, {}, {}, []
    shutil.rmtree(PHASE23_DIR, ignore_errors=True)
    os.makedirs(PHASE23_DIR)
    # float32 as the ranks compute it, whatever ran before in this process
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # one part after another: (b)'s ranks beside (a)'s made both slower on one card
    try:
        for key, fn in (("trainers", p23_trainers), ("mp", p23_mp), ("remat", p23_remat),
                        ("routes", p23_routes)):
            t0 = time.perf_counter()
            try:  # every part runs; the phase fails after them if one did
                rep[key] = fn(dev, launches)
            except Exception as e:
                errors.append(f"({key}) {type(e).__name__}: {e}")
                log(f"[p23] {key}: FAILED: {type(e).__name__}: {e}")
            seconds[key] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    rep["seconds"] = seconds
    log(f"[p23] phase 23 in {sum(seconds.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    if errors:
        raise AssertionError("phase 23: " + " | ".join(errors))
    return rep, launches


# ---------------------------------------------------------------------------
# Phase 24: the INT8 depthwise kernel
# ---------------------------------------------------------------------------


def depthwise_phase(dev):
    """Phase 24: the depthwise kernel against its plain version at batch 8 on
    codes at an odd byte offset and at a channel multiplier of 4, then
    checked and timed at the segmentation cell's 15 shapes. Returns (report,
    max error)."""
    from scripts.time_depthwise_int8 import case, run

    err, extra = 0, []
    for shape, m in (((64, 128, 120, 5, 1, 1), 1), ((32, 64, 672, 5, 1, 2), 1),
                     ((19, 19, 32, 3, 2, 1), 4)):
        x, op = case(shape, 7, dev)
        if m > 1:  # the SSD extras' 3x3 maps: output channel oc reads input oc // 4
            g = torch.Generator().manual_seed(8)
            qw = torch.randint(-128, 128, (3, 3, 1, 4 * shape[2]), generator=g,
                               dtype=torch.int8)
            op = depthwise_operands(qw, torch.full((4 * shape[2],), 1e-4), torch.zeros(
                4 * shape[2]), 97, 0.05, 128, False, 0, 255, 2, 1, (1, 1), dev)
        buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)
        odd = buf[1:].view(x.shape)
        odd.copy_(x)
        want = depthwise_int8_plain(x, op)
        err = max(err, check_equal(f"depthwise {shape} m {m}", depthwise_int8(x, op), want),
                  check_equal(f"depthwise {shape} m {m}, one byte in", depthwise_int8(odd, op),
                              want))
        extra.append(f"{'x'.join(map(str, shape))} m {m}")
    torch.cuda.synchronize()
    log(f"[depthwise] depthwise_int8 == plain at batch 8, aligned and one byte into the "
        f"storage: {extra}")
    rep = run(dev, log=lambda line: log(f"[time] depthwise_int8 {line.strip()}"))
    return {"checked": extra, **rep}, err


# ---------------------------------------------------------------------------
# Phase 25: the bilinear resize kernel
# ---------------------------------------------------------------------------


def resize_phase(dev):
    """Phase 25: the resize kernel checked and timed at the segmentation
    cell's three resizes (``scripts/time_resize_bilinear.py``), beside the
    plain chain and ``F.interpolate``. Returns (report, max error): the
    script raises where a bit differs."""
    from scripts.time_resize_bilinear import run

    return run(dev, log=lambda line: log(f"[time] resize_bilinear {line.strip()}")), 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke.json"))
    ap.add_argument("--p23-trainer", default=None, help=argparse.SUPPRESS)  # a phase 23 rank
    ap.add_argument("--p23-dir", default=PHASE23_DIR, help=argparse.SUPPRESS)
    ap.add_argument("--p23-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--p23-alone", action="store_true",
                    help="build the kernels and run phase 23 alone, with torch's default "
                         "settings; its report to --out")
    args = ap.parse_args(argv)
    if args.p23_trainer:
        return p23_trainer_rank(args.p23_trainer, args.p23_dir, args.p23_device)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    if args.p23_alone:
        log(f"[card] {card_line()}")
        cuda_build.build(cuda_build.SOURCES)
        rep, launches = last_configs_phase(torch.device("cuda"))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "last_configs": rep, "launches": launches}, f,
                      indent=1)
        return 0
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
                     "int8_conv": 0, "depthwise_int8": 0, "resize_bilinear": 0},
              False: {"frost_block_int8": 0, "int8_matmul_requant": 52, "fake_quant_observe": 0,
                      "int8_conv": 0, "depthwise_int8": 18, "resize_bilinear": 0}}
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

    # 19. GAN training: the fake-quant kernel at the generator's QAT sites,
    # pix2pix and CycleGAN against the JAX references, the trainer, tester,
    # server and scorer, timings
    torch.cuda.empty_cache()
    report["gan_train"], gan_train_counts = gan_train_phase(dev)
    max_err["fake_quant_observe"] = max(max_err["fake_quant_observe"],
                                        report["gan_train"]["fake_quant_max_abs_err"])

    # 20. the rest of the zoo: VGG, ShuffleNetV2, AlexNet, ESPNetv2 and ESPNet
    # served against the JAX digests, the dense conv at its odd channel
    # counts, the QAT and FP32 steps, ESPNet's against the JAX reference,
    # the ESPNetv2 trainer and evaluator
    torch.cuda.empty_cache()
    report["zoo"], zoo_counts, zoo_conv_rows, zoo_err = zoo_phase(dev)
    timing["int8_conv"] += zoo_conv_rows
    for k, v in zoo_err.items():
        max_err[k] = max(max_err[k], v)

    # 21. the rest of serving and the tools: seg serving, the serialized
    # programs, the dilated FrostNet features, the numeric suite, latency_check
    torch.cuda.empty_cache()
    report["tools"], tools_counts = tools_phase(dev)

    # 22. the native loaders, data parallelism (two ranks on this card, the
    # fake-quant kernel's data-parallel route) and serve --dp
    torch.cuda.empty_cache()
    report["dp"], dp_counts = dp_phase(dev)

    # 23. the last configurations: the seg, det and GAN trainers on two ranks,
    # mp 2 and dp 2 x mp 2, remat, the INT8 routes once refused
    torch.cuda.empty_cache()
    report["last_configs"], last_counts = last_configs_phase(dev)

    # 24. the INT8 depthwise kernel at the segmentation cell's 15 shapes
    torch.cuda.empty_cache()
    report["depthwise"], max_err["depthwise_int8"] = depthwise_phase(dev)
    dw = report["depthwise"]["total"]

    # 25. the bilinear resize kernel at the segmentation cell's 3 resizes
    torch.cuda.empty_cache()
    report["resize"], max_err["resize_bilinear"] = resize_phase(dev)
    rz = report["resize"]["total"]

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
        summary("int8_conv", CONV_SOURCE, CONV_REPLACES, (None,), gan_counts["int8_conv"]),
        {"name": "depthwise_int8", "route": "cuda", "source": DW_SOURCE,
         "replaces": DW_REPLACES,
         "launches": report["tools"]["seg_serving"]["launches"]["depthwise_int8"],
         "max_abs_err": max_err["depthwise_int8"], "ms": dw["device_ms"],
         "plain_ms": dw["plain_ms"], "bound_ms": dw["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "device_ms": dw["graph_all_ms"],
         "plain_launches": dw["plain_launches"]},
        {"name": "resize_bilinear", "route": "cuda", "source": RESIZE_SOURCE,
         "replaces": RESIZE_REPLACES,
         "launches": report["tools"]["seg_serving"]["launches"]["resize_bilinear"],
         "max_abs_err": max_err["resize_bilinear"], "ms": rz["device_ms"],
         "plain_ms": rz["plain_ms"], "bound_ms": rz["bound_ms"], "bound_by": "bytes",
         "library_ms": rz["library_ms"], "device_ms": rz["graph_all_ms"],
         "plain_launches": rz["plain_launches"]}]}
    for entry in kernels["kernels"]:
        entry["trainer_launches"] = trainer_counts[entry["name"]]
        for key, path_counts in (("mobilenet_launches", mb_counts),
                                 ("resnet_launches", rn_counts), ("seg_launches", seg_counts),
                                 ("det_launches", det_counts),
                                 ("gan_train_launches", gan_train_counts),
                                 ("zoo_launches", zoo_counts),
                                 ("tools_launches", tools_counts),
                                 ("dp_launches", dp_counts),
                                 ("last_configs_launches", last_counts)):
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
