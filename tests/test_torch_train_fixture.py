"""The committed training reference of the PyTorch port.

``frostnet_tpu_torch/testdata/frostnet_quant_large_1_0_train_reference.npz``
holds what the JAX package computes on the CPU for the training path that
``chip_smoke.py`` drives on the GPU, so that the port can be held against
it there without JAX. No weights are committed: both packages start from
``frostnet_tpu_torch.quant.numpy_init(model, seed 0)``.

The run: ``frostnet_quant_large_1_0`` (qnnpack, 1000 classes, ``drop_rate``
0), float32, 224x224, batch 8; QSGD with lr 0.04,
``grouped_weight_decay(4e-5)`` and ``noise_decay=1.0`` (the GradBoost noise
is then exactly 0: its draws cannot match between the packages); one FP32
step on batch 0, ``start_qat``, QAT steps on batches 1 and 2, then one
QAT_FROZEN eval step on batch 3. Batch ``k`` is
``RandomState(100 + k)``: ``randint(0, 256, (8, 224, 224, 3))`` as uint8
images (normalized on the device), then ``randint(0, 1000, 8)`` labels.

Keys: ``loss`` and ``top1`` (4,) for the four steps; every observer's state
after the last step as ``quant/<path>.min_val|max_val``, every BN's running
statistics as ``batch_stats/<path>/mean|var``; ``__meta__`` (JSON).

Regenerate with ``python tests/test_torch_train_fixture.py`` (several
minutes on the CPU); under pytest this file checks the keys and shapes.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "frostnet_tpu_torch", "testdata",
                         "frostnet_quant_large_1_0_train_reference.npz")
MODEL, IMAGE, BATCH, CLASSES, SEED, LR, WD = "frostnet_quant_large_1_0", 224, 8, 1000, 0, 0.04, 4e-5
N_OBSERVERS, N_BN = 166, 69  # per-tensor sites (qnnpack); QConvBNAct with BN


def make_reference(path=REFERENCE):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from _torch_port import jax_train_state, train_batch
    from frostnet_tpu.models import create_model as jax_create_model
    from frostnet_tpu.nn import FP32, QAT, QAT_FROZEN
    from frostnet_tpu.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu.train.state import make_eval_step, make_train_step
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables

    tree = numpy_init(create_model(MODEL, num_classes=CLASSES), SEED)
    model = jax_create_model(MODEL, num_classes=CLASSES, drop_rate=0.0)
    tx = get_optimizer("QSGD", LR, weight_decay=grouped_weight_decay(WD), noise_decay=1.0)
    state = jax_train_state(model, tree, tx)
    steps = [make_train_step(model, FP32, num_classes=CLASSES, donate=False),
             make_train_step(model, QAT, num_classes=CLASSES, donate=False),
             make_train_step(model, QAT, num_classes=CLASSES, donate=False)]
    losses, top1 = [], []
    for k, step in enumerate(steps):
        if k == 1:
            state = state.start_qat()
        state, m = step(state, train_batch(k, BATCH, IMAGE, CLASSES))
        losses.append(float(m["loss"]))
        top1.append(float(m["top1"]))
        print(f"step {k}: loss {losses[-1]:.6f} top1 {top1[-1]}", flush=True)
    m = make_eval_step(model, QAT_FROZEN, num_classes=CLASSES)(
        state, train_batch(3, BATCH, IMAGE, CLASSES))
    losses.append(float(m["loss"]))
    top1.append(float(m["top1"]))
    flat = flatten_variables(jax.tree.map(np.asarray, {"batch_stats": state.batch_stats,
                                                       "quant": state.quant}))
    meta = dict(model=MODEL, image=IMAGE, batch=BATCH, classes=CLASSES, seed=SEED, lr=LR,
                weight_decay=WD, steps=["FP32", "start_qat", "QAT", "QAT", "QAT_FROZEN eval"],
                jax=jax.__version__)
    np.savez_compressed(path, loss=np.asarray(losses, np.float32),
                        top1=np.asarray(top1, np.float32),
                        __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                        **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    print("wrote", path, "losses", losses, "top1", top1)


def test_train_reference_keys_and_shapes():
    ref = np.load(REFERENCE)
    meta = json.loads(bytes(ref["__meta__"]).decode())
    assert (meta["model"], meta["image"], meta["batch"]) == (MODEL, IMAGE, BATCH)
    assert ref["loss"].shape == (4,) and ref["top1"].shape == (4,)
    assert np.isfinite(ref["loss"]).all() and (ref["loss"] > 0).all()
    mins = [k for k in ref.files if k.endswith(".min_val")]
    maxs = [k for k in ref.files if k.endswith(".max_val")]
    means = [k for k in ref.files if k.endswith("/mean")]
    var = [k for k in ref.files if k.endswith("/var")]
    assert len(mins) == len(maxs) == N_OBSERVERS
    assert len(means) == len(var) == N_BN
    for k in mins + maxs:
        assert ref[k].shape == () and np.isfinite(ref[k])  # every site observed
    for k in means + var:
        assert ref[k].ndim == 1 and np.isfinite(ref[k]).all()
    # observers and the statistics moved from their initial values
    assert all(float(ref[k]) <= float(ref[k.replace("min_val", "max_val")]) for k in mins)
    assert not all(np.all(ref[k] == 1.0) for k in var)


def test_reference_keys_match_the_port_model():
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.quant import model_variables

    ref = np.load(REFERENCE)
    mine = {k: tuple(v.shape) for k, v in model_variables(create_model(MODEL)).items()
            if k.startswith(("quant/", "batch_stats/"))}
    got = {k: ref[k].shape for k in ref.files if k.startswith(("quant/", "batch_stats/"))}
    assert got == mine


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    make_reference()
