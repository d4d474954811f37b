"""PyTorch port, the classification trainer and evaluator against the JAX package's.

``frostnet_quant_small_0_35`` at 32x32, 10 classes, synthetic data, batch 8,
one step an epoch: one FP32 (StatAssist) epoch, one QAT epoch with its
QAT_FROZEN validation, then the final QAT_FROZEN and INT8 evaluations. Both
packages' ``main`` start from the same weights (each side's
``create_train_state`` is patched to take the port's ``numpy_init``
variables, carried across by ``from_jax_variables``), with dropout off and
the GradBoost noise off (``noise_decay=1.0`` makes its amplitude 0): neither
package's draws can match the other's. The JAX run is one module-scoped
fixture, on one CPU device. Losses and top-1 are held to the bands of
``tests/test_torch_train_step.py``; both runs write the same files and the
same ``metrics.jsonl`` keys. The reference's ``setting/*.json`` layout is
written here (the reference repository is not needed).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.quant import numpy_init
from frostnet_tpu_torch.train import classification, evaluate
from test_torch_train_step import FP32_LOSS_REL, QAT_LOSS_REL

MODEL, SIZE, BATCH, CLASSES = "frostnet_quant_small_0_35", 32, 8, 10
# lr 1e-3: at random init the logits are ~30, and at the trainer's default
# 0.04 the FP32 step moves this small model so far that the QAT epoch's loss
# differs by 50% between two runs of the port itself on 2 and on 8 CPU
# threads (measured: 52.3 and 33.5; JAX 34.8); at 1e-3 the port on 2 and 8
# threads and JAX give 15.9, 16.8 and 14.5, and the validation 3.44, 3.46
# and 3.48.
SMALL = dict(model=MODEL, num_classes=CLASSES, image_size=SIZE, batch_size=BATCH,
             steps_per_epoch=1, fp_epochs=1, epochs=1, noise_decay=1.0, log_every=1,
             learning_rate=1e-3)
pytestmark = pytest.mark.usefixtures("few_threads")

REFERENCE_TRAIN_JSON = {
    "train_config": {"Model": "frostnet_quant_small_0_35", "FP_epoch": 2, "epochs": 7,
                     "batch_size": 16, "learning_rate": 0.01, "optim": "QAdamW",
                     "lrsch": "step_lr", "warmup_epoch": 1, "weight_decay": 1e-4,
                     "resume": "runs/x/checkpoint", "amsgrad": True, "num_work": 4},
    "data_config": {"dataset_name": "ILSVRC2015", "w": 224, "h": 224, "num_classes": 1000,
                    "data_dir": "/data"},
    "seed": 3, "not_a_knob": 1,
}


def _init(seed=0):
    return numpy_init(create_model(MODEL, num_classes=CLASSES, drop_rate=0.0), seed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``main`` on the same weights; the JAX one compiles its
    FP32, QAT, QAT_FROZEN and INT8 programs once here."""
    import jax

    from frostnet_tpu.models import create_model as jax_create_model
    from frostnet_tpu.parallel import make_mesh
    from frostnet_tpu.train import classification as jcls

    root = tmp_path_factory.mktemp("classification")
    tree = _init()
    mp = pytest.MonkeyPatch()
    try:
        jax_make = jcls.create_train_state

        def jax_state(model, tx, rng, sample, **kw):
            st = jax_make(model, tx, rng, sample, **kw)
            v = jax_variables(tree)
            return st.replace(params=v["params"], batch_stats=v["batch_stats"], quant=v["quant"],
                              opt_state=tx.init(v["params"]))

        mp.setattr(jcls, "create_train_state", jax_state)
        # one device, as the port runs (the tests' 8 virtual CPU devices would
        # shard the batch and compile the SPMD programs, several minutes)
        mp.setattr(jcls, "make_mesh", lambda mp=1: make_mesh(devices=jax.devices()[:1]))
        mp.setattr(jcls, "create_model", lambda name, **kw: jax_create_model(
            name, drop_rate=0.0, **kw))
        jcfg = jcls.ClassificationConfig(save_dir=str(root / "jax"), **SMALL)
        _, jres = jcls.main(jcfg)

        port_make = classification.create_train_state
        mp.setattr(classification, "create_train_state",
                   lambda model, tx, **kw: port_make(model, tx, variables=tree, **kw))
        mp.setattr(classification, "create_model", lambda name, **kw: create_model(
            name, drop_rate=0.0, **kw))
        cfg = classification.ClassificationConfig(save_dir=str(root / "port"), device="cpu",
                                                  **SMALL)
        state, res = classification.main(cfg)
    finally:
        mp.undo()
    return {"root": root, "jax": jres, "port": res, "state": state, "cfg": cfg}


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_main_writes_the_files_of_the_jax_trainer(runs):
    jax_dir, port_dir = runs["root"] / "jax", runs["root"] / "port"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == [
        "best", "checkpoint", "checkpoint_meta.json", "metrics.jsonl"]
    with open(port_dir / "checkpoint_meta.json") as f, open(jax_dir / "checkpoint_meta.json") as g:
        mine, theirs = json.load(f), json.load(g)
    assert set(mine) == set(theirs) and mine["qat_epoch"] == theirs["qat_epoch"] == 1
    a, b = _records(port_dir), _records(jax_dir)
    assert [sorted(r) for r in a] == [sorted(r) for r in b]
    assert [r["step"] for r in a] == [r["step"] for r in b] == [1, 2, 2]
    assert all(np.isfinite(v) for r in a for k, v in r.items() if k != "time")


def test_losses_and_top1_within_the_bands_of_the_train_step(runs):
    """The FP32 epoch's loss is the first step's (same weights, same
    batch): the float band. The QAT epoch, its validation and the final
    evaluations follow a QAT step: the QAT band. Top-1 within one image."""
    a, b = _records(runs["root"] / "port"), _records(runs["root"] / "jax")
    fp32 = abs(a[0]["fp_warmup/loss"] - b[0]["fp_warmup/loss"]) / b[0]["fp_warmup/loss"]
    assert fp32 <= FP32_LOSS_REL, fp32
    pairs = [(a[1]["qat/loss"], b[1]["qat/loss"]), (a[2]["val/loss"], b[2]["val/loss"])]
    for key in ("qat", "int8"):
        pairs.append((runs["port"][key]["loss"], runs["jax"][key]["loss"]))
        assert abs(runs["port"][key]["top1"] - runs["jax"][key]["top1"]) <= 1.0 / BATCH + 1e-9
    for mine, theirs in pairs:
        assert np.isfinite(mine) and abs(mine - theirs) / theirs <= QAT_LOSS_REL, (mine, theirs)


def test_int8_evaluation_freezes_the_final_state(runs):
    """The INT8 evaluation ran on the frozen graph of the trained state: a
    fresh freeze of the returned model gives the same metrics."""
    state, cfg = runs["state"], runs["cfg"]
    ds = classification._build_dataset(cfg, train=False)
    again = classification.evaluate(state, ds, torch.device("cpu"), classification.INT8,
                                    CLASSES, cfg.steps_per_epoch, image_size=SIZE)
    assert again["loss"] == runs["port"]["int8"]["loss"]
    assert again["top1"] == runs["port"]["int8"]["top1"]


def test_resume_continues_from_the_checkpoint(runs, tmp_path):
    """A resume with one more QAT epoch starts at QAT epoch 1, step 2, with
    the schedule's count at 2."""
    port_dir = runs["root"] / "port"
    cfg = classification.ClassificationConfig(save_dir=str(port_dir), device="cpu",
                                              resume=True, **{**SMALL, "epochs": 2})
    state, res = classification.main(cfg)
    assert (res["resumed"]["qat_epoch"], res["resumed"]["step"], res["resumed"]["count"]) == (
        1, 2, 2)
    assert res["resumed"]["noise_generator"] is not None
    assert state.step == 3 and [h["tag"] for h in res["history"]] == ["qat"]
    with open(port_dir / "checkpoint_meta.json") as f:
        assert json.load(f)["qat_epoch"] == 2


def test_evaluate_exports_an_artifact_that_round_trips(runs, tmp_path):
    from frostnet_tpu_torch.quant import freeze, from_jax_variables, load_int8

    path = str(tmp_path / "int8.npz")
    args = evaluate.build_parser([]).parse_args(
        ["--model", MODEL, "--checkpoint", str(runs["root"] / "port" / "best"),
         "--num_classes", str(CLASSES), "--image_size", str(SIZE), "--batch_size", "4",
         "--calib_batches", "1", "--use_ema", "--export_int8", path, "--device", "cpu"])
    out = evaluate.main(args)
    assert out["export_bytes"] == os.path.getsize(path)
    assert np.isfinite(out["qat"]["loss"]) and np.isfinite(out["int8"]["loss"])
    assert out["int8_size_mb"] == evaluate.int8_model_size_bytes(out["state"].model) / 1e6
    served = create_model(MODEL, num_classes=CLASSES)
    from_jax_variables(served, load_int8(path))
    direct = create_model(MODEL, num_classes=CLASSES)
    direct.load_state_dict(out["state"].model.state_dict())
    images = np.random.RandomState(2).randn(4, SIZE, SIZE, 3).astype(np.float32)
    assert torch.equal(freeze(served, "cpu", SIZE)(images), freeze(direct, "cpu", SIZE)(images))


def test_evaluate_without_a_checkpoint_calibrates_with_one_step():
    args = evaluate.build_parser([]).parse_args(
        ["--model", MODEL, "--num_classes", str(CLASSES), "--image_size", str(SIZE),
         "--batch_size", "4", "--layer_report", "3", "--device", "cpu"])
    out = evaluate.main(args)
    assert out["state"].step == 1 and np.isfinite(out["int8"]["loss"])
    # the numeric suite's report on the first evaluation batch
    rows = out["layer_report"]
    assert {"<output>", "conv1", "layer1_0/conv2"} <= {r.path for r in rows}
    assert rows == sorted(rows, key=lambda r: r.sqnr_db)


def test_from_json_reads_the_reference_layout_as_jax_does(tmp_path):
    from frostnet_tpu.train.classification import ClassificationConfig as JaxConfig
    from frostnet_tpu.train.evaluate import _json_defaults as jax_json_defaults

    path = tmp_path / "train.json"
    path.write_text(json.dumps(REFERENCE_TRAIN_JSON))
    mine = dataclasses.asdict(classification.ClassificationConfig.from_json(str(path)))
    theirs = dataclasses.asdict(JaxConfig.from_json(str(path)))
    assert mine.pop("device") == "cuda"
    assert mine == theirs
    assert mine["resume_path"] == "runs/x/checkpoint" and mine["resume"] is True
    assert mine["dataset"] == "imagenet" and mine["fp_epochs"] == 2
    ev = tmp_path / "evaluate.json"
    ev.write_text(json.dumps({"test_config": {"Model": MODEL, "weight_name": ""},
                              "data_config": {"dataset_name": "cifar10", "num_classes": 10}}))
    assert evaluate._json_defaults(str(ev)) == jax_json_defaults(str(ev))
    args = evaluate.build_parser(["-c", str(ev)]).parse_args(["-c", str(ev), "--batch_size", "2"])
    assert (args.model, args.dataset, args.num_classes, args.batch_size, args.checkpoint) == (
        MODEL, "cifar10", 10, 2, None)


def test_cli_help_and_flags(capsys):
    for parser in (classification.build_parser(), evaluate.build_parser([])):
        with pytest.raises(SystemExit) as e:
            parser.parse_args(["--help"])
        assert e.value.code == 0
    assert "--device" in capsys.readouterr().out
    cfg = classification.config_from_args(classification.build_parser().parse_args(
        ["--epochs", "3", "--learning_rate", "0.1", "--toss_coin", "false", "--device", "cpu"]))
    assert (cfg.epochs, cfg.learning_rate, cfg.toss_coin, cfg.device) == (3, 0.1, False, "cpu")
    assert classification.ClassificationConfig().device == "cuda"


def test_unported_options_raise(tmp_path):
    # a dp x 2 mesh needs an even number of ranks: one process holds none
    # (two ranks run it: tests/test_torch_mp.py)
    with pytest.raises(ValueError, match=r"dp\*mp = 0\*2 != 1"):
        classification.main(classification.ClassificationConfig(
            mp=2, device="cpu", save_dir=str(tmp_path)))
    # the native loader is ported: a missing image folder raises, nothing
    # falls back to the PIL loader
    cfg = classification.ClassificationConfig(dataset="imagenet", loader="native", device="cpu",
                                              data_dir=str(tmp_path / "missing"),
                                              save_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        classification.main(cfg)
