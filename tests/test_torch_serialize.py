"""PyTorch port, the serialized serving program (``quant/serialize.py``).

``frostnet_quant_small_0_35`` at 32x32, 10 classes, from the port's numpy
init with its observers calibrated by one QAT forward, written by the
port's ``export_int8``; both packages serve that artifact. Held exactly
(the program runs the frozen graph's own ops):

* a program exported on a symbolic batch gives the in-process predictor's
  logits bit for bit at batch 2 and 3, and calls the kernels'
  ``torch.library`` ops (no other route to them). The fused model is
  exported here; the unfused one's program (slow to export and load on the
  CPU: every requant is a chain of torch ops) is held on the card,
  ``chip_smoke.py`` phase 21;
* a static-batch program serves its batch and rejects another;
* the program loads and runs in a process that never imports the model code
  (``frostnet_tpu_torch.models``, ``.nn``);
* its logits equal JAX's ``load_serving`` of JAX's ``export_serving`` on the
  same variables;
* ``serve --export_program`` then ``serve --program`` serves the same
  logits, and the CLI keeps JAX's refusals;
* the kernels' ops take their operands by name (the block's lists decode
  back to the same spec and operands), and the block op's launch plans,
  kept by its reduce weight, go when that weight goes;
* the INT8 depthwise sum, one grouped conv in an exported graph, equals
  the eager loop over taps.
"""
import dataclasses
import gc
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostnet_tpu.models import create_model as jax_create_model
from frostnet_tpu.quant import load_int8 as jax_load_int8
from frostnet_tpu.quant.serialize import export_serving as jax_export_serving
from frostnet_tpu.quant.serialize import load_serving as jax_load_serving
from frostnet_tpu_torch import serve
from frostnet_tpu_torch.ops import frost_block as fb
from frostnet_tpu_torch.ops.requant import depthwise_acc
from frostnet_tpu_torch.ops.int8_conv import Conv3x3Operands
from frostnet_tpu_torch.ops.int8_matmul import MatmulOperands
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.quant import export_int8, export_serving, load_serving
from frostnet_tpu_torch.train import create_train_state, recalibrate

NAME, SIZE = "frostnet_quant_small_0_35", 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    state = create_train_state(create_model(NAME, num_classes=10), None, device="cpu")
    images = np.random.RandomState(3).randn(2, SIZE, SIZE, 3).astype(np.float32)
    recalibrate(state, [{"image": images}])
    d = tmp_path_factory.mktemp("serialize")
    path = str(d / "int8.npz")
    export_int8(state.model, path)
    return path, d


def _predictor(path, fuse):
    return serve.Int8Predictor(NAME, num_classes=10, artifact=path, image_size=SIZE,
                               fuse_int8=fuse, device="cpu")


def test_program_round_trip_is_exact_and_batch_polymorphic(artifact):
    path, d = artifact
    pred = _predictor(path, True)
    prog = str(d / "dynamic.pt2")
    assert pred.export_program(prog) == os.path.getsize(prog) > 0
    served = load_serving(prog, "cpu")
    rng = np.random.RandomState(7)
    for batch in (2, 3):
        x = rng.randn(batch, SIZE, SIZE, 3).astype(np.float32)
        got = served(x)
        assert got.shape == (batch, 10) and got.dtype == torch.float32
        assert torch.equal(got, pred(x))
    program = torch.export.load(prog)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    kernels = {t for t in targets if t.startswith("frostnet.")}
    assert kernels == {"frostnet.frost_block_int8.default",
                       "frostnet.int8_matmul_requant.default"}


def test_static_batch_program_rejects_another_batch(artifact):
    path, d = artifact
    pred = _predictor(path, True)
    prog = str(d / "static.pt2")
    export_serving(pred.model, prog, image_size=SIZE, batch=2)
    served = load_serving(prog, "cpu")
    x = np.random.RandomState(8).randn(3, SIZE, SIZE, 3).astype(np.float32)
    assert torch.equal(served(x[:2]), pred(x[:2]))
    with pytest.raises(AssertionError, match="Guard failed"):
        served(x)


def test_program_loads_without_the_model_code_and_equals_jax(artifact):
    path, d = artifact
    prog = str(d / "alone.pt2")
    _predictor(path, True).export_program(prog)
    x = np.random.RandomState(9).randn(3, SIZE, SIZE, 3).astype(np.float32)
    np.save(str(d / "x.npy"), x)
    code = ("import sys, numpy as np; from frostnet_tpu_torch.quant.serialize import "
            f"load_serving; fn = load_serving({prog!r}, 'cpu'); "
            f"np.save({str(d / 'y.npy')!r}, fn(np.load({str(d / 'x.npy')!r})).numpy()); "
            "bad = [m for m in sys.modules if m.startswith(('frostnet_tpu_torch.models', "
            "'frostnet_tpu_torch.nn', 'jax', 'frostnet_tpu.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = np.load(str(d / "y.npy"))
    jax_prog = str(d / "jax.bin")
    jax_export_serving(jax_create_model(NAME, num_classes=10), jax_load_int8(path), jax_prog,
                       image_size=SIZE, platforms=("cpu",))
    want = np.asarray(jax_load_serving(jax_prog)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_serve_exports_and_serves_a_program(artifact):
    path, d = artifact
    prog, saved = str(d / "cli.pt2"), str(d / "cli.npy")
    common = ["--num_classes", "10", "--image_size", str(SIZE), "--batch_size", "2",
              "--iters", "1", "--device", "cpu"]
    serve.main(serve.build_parser().parse_args(
        ["--model", NAME, "--artifact", path, "--fuse_int8", "--export_program", prog] + common))
    rep = serve.main(serve.build_parser().parse_args(
        ["--program", prog, "--save_logits", saved] + common))
    assert rep["model"] == f"program:{prog}"
    x = np.random.RandomState(0).randn(2, SIZE, SIZE, 3).astype(np.float32)
    np.testing.assert_array_equal(np.load(saved), _predictor(path, False)(x).numpy())
    parse = serve.build_parser().parse_args
    with pytest.raises(ValueError, match="exactly one of"):
        serve.main(parse(["--artifact", path, "--program", prog] + common))
    with pytest.raises(SystemExit, match="classification-only"):
        serve.main(parse(["--workload", "seg", "--program", prog, "--device", "cpu"]))
    with pytest.raises(ValueError, match="nothing to re-export"):
        serve.Int8Predictor(program=prog, device="cpu").export_program(str(d / "again.pt2"))


SQUEEZE = fb.FrostBlockSpec(h=8, w=8, cin=16, cout=16, kernel=3, stride=1, has_squeeze=True,
                            has_expand=True, c_sq=8, c_e=48, residual=True)
PLAIN = fb.FrostBlockSpec(h=8, w=8, cin=16, cout=24, kernel=5, stride=2, has_squeeze=False,
                          has_expand=False, c_sq=0, c_e=16, residual=False, act_qmax=127)


@pytest.mark.parametrize("spec", [SQUEEZE, PLAIN], ids=["squeeze_expand", "neither"])
def test_kernel_ops_take_their_operands_by_name(spec):
    for name, cls in (("int8_matmul_requant", MatmulOperands),
                      ("conv3x3_s1_int8", Conv3x3Operands)):
        schema = getattr(torch.ops.frostnet, name).default._schema
        assert [a.name for a in schema.arguments] == ["x"] + [f.name for f in
                                                             dataclasses.fields(cls)]
    x, p = fb.random_block_case(spec, 2, seed=1)
    tensors, ints, floats = fb.op_args(spec, p)
    assert tensors[0] is p.rd.wt and len(tensors) == 4 * (2 + spec.has_squeeze + spec.has_expand)
    got_spec, got = fb.from_op_args(tensors, ints, floats)
    assert got_spec == spec and got == p
    want = fb.frost_block_int8_plain(x, p, spec)
    assert torch.equal(torch.ops.frostnet.frost_block_int8(x, tensors, ints, floats), want)
    assert torch.equal(fb.frost_block_int8(x, p, spec), want)


def test_block_plans_go_with_their_reduce_weight(monkeypatch):
    """The op's CUDA implementation (its planning and launch stubbed: this
    runs on the CPU) plans once per reduce weight and batch; dropping the
    block's operands frees the plans, and a block sharing that weight with
    other scalars gets plans of its own."""
    made = []

    def prepare(spec, p, batch, device):
        made.append(spec)
        return p.packed  # what a plan keeps: packed copies

    monkeypatch.setattr(fb, "prepare_launch", prepare)
    monkeypatch.setattr(fb, "_launch", lambda x, spec, launch: x)
    x, p = fb.random_block_case(SQUEEZE, 2, seed=2)
    tensors, ints, floats = fb.op_args(SQUEEZE, p)
    before = len(fb._PLANS)
    for _ in range(2):
        fb._op_cuda(x, tensors, ints, floats)
    fb._op_cuda(x[:1], tensors, ints, floats)
    assert made == [SQUEEZE, SQUEEZE] and len(fb._PLANS) == before + 1
    other = fb.op_args(SQUEEZE, dataclasses.replace(p, add_zp=p.add_zp + 1))
    fb._op_cuda(x, *other)
    assert len(made) == 3 and fb._PLANS[p.rd.wt].ints == other[1]
    del p, tensors, other
    gc.collect()
    assert len(fb._PLANS) == before


@pytest.mark.parametrize("kernel,stride,dilation,mult", [(3, 1, 1, 1), (5, 2, 1, 1), (3, 1, 2, 1),
                                                        (5, 1, 4, 1), (3, 2, 1, 4)])
def test_exported_depthwise_sum_equals_the_taps(kernel, stride, dilation, mult):
    rng = np.random.RandomState(kernel * 100 + stride * 10 + dilation + mult)
    x = torch.as_tensor(rng.randint(0, 256, (2, 13, 11, 6)).astype(np.uint8))
    w = torch.as_tensor(rng.randint(-128, 128, (kernel * kernel, 6 * mult)).astype(np.int8))

    class Depthwise(torch.nn.Module):
        def forward(self, x):
            return depthwise_acc(x, w, kernel, stride, 97, dilation)

    prog = torch.export.export(Depthwise(), (x,), dynamic_shapes={"x": {0: torch.export.Dim("b")}})
    targets = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
    assert sum("conv" in t for t in targets) == 1 and len(targets) < 20  # the taps: 9 x ~5
    want = Depthwise()(x)
    assert want.dtype == torch.int32 and len(torch.unique(want)) > 100
    assert torch.equal(prog.module()(x), want)
    assert torch.equal(prog.module()(x[:1]), want[:1])
