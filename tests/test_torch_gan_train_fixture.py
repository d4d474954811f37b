"""The committed GAN training references of the PyTorch port.

``frostnet_tpu_torch/testdata`` holds what the JAX package's training
steps compute at full width from weights both packages can make, so that
``chip_smoke.py`` phase 19 can hold the port's training against JAX on the
GPU without JAX. No weights are committed: both start from
``numpy_init(nets, 0, init="gan")`` (kernels ``N(0, 0.02)``, BN scales
``1 + 0.02 N``, drawn with numpy in key order) of ``chip_smoke.gan_train_nets``
(``resnet_9blocks`` generators at ngf 64, ``basic`` PatchGANs at ndf 64), on
``chip_smoke.gan_train_batches`` (``SyntheticPairs(256, ..., seed 0)``,
batch 1), float32 (the JAX matmul precision "highest"), QAdam (b1 0.5,
``noise_decay=1.0``: the GradBoost noise exactly 0) on the generators and
Adam on the discriminators at lr 2e-4:

* ``gan_pix2pix_train_reference.npz``: the D conditional with BN; one FP32
  iteration (``d_step``, then ``g_step``), ``set_warmup(False)``, two QAT
  iterations, then a QAT_FROZEN forward of G on the fourth batch's A. Keys:
  ``loss_D``, ``loss_G``, ``loss_G_GAN``, ``loss_G_L1`` (3,); ``fp32/G/...``
  and ``fp32/D/...``, every BN statistic after the FP32 iteration;
  ``G/...`` (every BN statistic and observer) and ``D/...`` (every BN
  statistic) after the last; ``frozen_out_sampled``, the QAT_FROZEN output
  at every ``GAN_SAMPLE``-th row and column; ``__meta__``.
* ``gan_cyclegan_train_reference.npz``: two generators and two Ds without
  norm; one FP32 and one QAT iteration, each ``g_step``, the two
  ``ImagePool.query`` calls (seeds 0 and 1) and both ``d_step``s. Keys:
  ``loss_G``, ``cyc_A``, ``cyc_B``, ``loss_D_A``, ``loss_D_B`` (2,);
  ``fp32/G_A/...`` and ``fp32/G_B/...`` after the FP32 iteration;
  ``G_A/...`` and ``G_B/...`` after the last (each generator's state after
  its second apply); ``fake_a_sampled`` and ``fake_b_sampled`` of the FP32
  iteration; ``__meta__``.

Regenerate with ``python tests/test_torch_gan_train_fixture.py`` (about 6
CPU minutes; ``pix2pix`` or ``cyclegan`` as arguments). Under pytest this
file checks the references' keys and shapes against the port's nets.
"""
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script (python tests/test_torch_gan_train_fixture.py)
    sys.path.insert(0, ROOT)
from chip_smoke import (CYCLEGAN_LOSSES, GAN_CYCLEGAN_REFERENCE,  # noqa: E402
                        GAN_PIX2PIX_REFERENCE, GAN_SAMPLE, GAN_TRAIN, PIX2PIX_LOSSES)


def _jax_setup(kind):
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_port import jax_variables
    from chip_smoke import gan_train_nets
    from frostnet_tpu import optim as jopt
    from frostnet_tpu.gan import models as jmodels
    from frostnet_tpu_torch.quant import numpy_init

    g = GAN_TRAIN
    trees = numpy_init(gan_train_nets(kind), g["seed"], init="gan")
    g_tx = jopt.qadam(g["lr"], b1=g["beta1"], noise_decay=1.0)
    d_tx = jopt.adam(g["lr"], b1=g["beta1"])

    def state(tree, tx):
        v = jax_variables(tree)
        return jmodels.NetState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                                quant=v.get("quant", {}), opt_state=tx.init(v["params"]), tx=tx)

    return trees, g_tx, d_tx, state


def _flat(prefix, state, cols=("batch_stats", "quant")):
    import jax

    from frostnet_tpu_torch.quant.export import flatten_variables

    tree = {c: getattr(state, c) for c in cols}
    return {f"{prefix}/{k}": np.asarray(v, np.float32)
            for k, v in flatten_variables(jax.tree.map(np.asarray, tree)).items()}


def _save(path, meta, **arrays):
    np.savez_compressed(path, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                        **arrays)
    print("wrote", path, os.path.getsize(path), "bytes")


def make_pix2pix_reference(path=GAN_PIX2PIX_REFERENCE):
    import jax
    import jax.numpy as jnp

    from chip_smoke import gan_train_batches
    from frostnet_tpu import optim as jopt
    from frostnet_tpu.gan import models as jmodels
    from frostnet_tpu.gan import networks as jnet
    from frostnet_tpu.nn import FP32, QAT, QAT_FROZEN

    trees, g_tx, d_tx, state = _jax_setup("pix2pix")
    g = GAN_TRAIN
    net_g, net_d = jnet.define_g(ngf=g["ngf"], netG=g["netG"]), jnet.define_d(g["ndf"])
    gs, ds = state(trees[0], g_tx), state(trees[1], d_tx)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in gan_train_batches(4)]
    losses, fp32 = {k: [] for k in PIX2PIX_LOSSES}, {}
    for k, mode in enumerate((FP32, QAT, QAT)):
        if k == 1:
            gs = gs.replace(opt_state=jopt.set_warmup(gs.opt_state, False))
        d_step, g_step = jmodels.make_pix2pix_steps(net_g, net_d, mode)
        ds, md = d_step(gs, ds, batches[k])
        gs, mg = g_step(gs, ds, batches[k])
        for key, v in {**md, **mg}.items():
            losses[key].append(float(v))
        print(f"iteration {k}: {[(key, v[-1]) for key, v in losses.items()]}", flush=True)
        if k == 0:
            fp32 = {f"fp32/{n}": v for n, v in {**_flat("G", gs, ("batch_stats",)),
                                                 **_flat("D", ds, ("batch_stats",))}.items()}
    out = jax.jit(lambda v, x: net_g.apply(v, x, mode=QAT_FROZEN))(gs.variables, batches[3]["A"])
    meta = dict(GAN_TRAIN, kind="pix2pix", gan_mode="lsgan", lambda_l1=100.0,
                steps=["FP32", "set_warmup(False)", "QAT", "QAT", "QAT_FROZEN forward"],
                jax=jax.__version__)
    _save(path, meta, frozen_out_sampled=np.asarray(out)[0, ::GAN_SAMPLE, ::GAN_SAMPLE],
          **{k: np.asarray(v, np.float32) for k, v in losses.items()},
          **fp32, **_flat("G", gs), **_flat("D", ds, ("batch_stats",)))


def make_cyclegan_reference(path=GAN_CYCLEGAN_REFERENCE):
    import jax
    import jax.numpy as jnp

    from chip_smoke import gan_train_batches
    from frostnet_tpu import optim as jopt
    from frostnet_tpu.gan import models as jmodels
    from frostnet_tpu.gan import networks as jnet
    from frostnet_tpu.gan.image_pool import ImagePool
    from frostnet_tpu.nn import FP32, QAT

    trees, g_tx, d_tx, state = _jax_setup("cycle_gan")
    g = GAN_TRAIN
    nets = (jnet.define_g(ngf=g["ngf"], netG=g["netG"]),
            jnet.define_g(ngf=g["ngf"], netG=g["netG"]),
            jnet.define_d(g["ndf"], norm="none"), jnet.define_d(g["ndf"], norm="none"))
    gA, gB = state(trees[0], g_tx), state(trees[1], g_tx)
    dA, dB = state(trees[2], d_tx), state(trees[3], d_tx)
    joint = g_tx.init((gA.params, gB.params))
    pool_a, pool_b = ImagePool(50, 0), ImagePool(50, 1)
    losses, fp32, fakes = {k: [] for k in CYCLEGAN_LOSSES}, {}, {}
    for k, (batch, mode) in enumerate(zip(gan_train_batches(2), (FP32, QAT))):
        if k == 1:
            joint = jopt.set_warmup(joint, False)
        g_step, d_step = jmodels.make_cyclegan_steps(*nets, mode)
        b = {n: jnp.asarray(v) for n, v in batch.items()}
        gA, gB, joint, fake_a, fake_b, m = g_step(gA, gB, dA, dB, b, joint)
        dA, loss_da = d_step(dA, b["B"], jnp.asarray(pool_b.query(np.asarray(fake_b))))
        dB, loss_db = d_step(dB, b["A"], jnp.asarray(pool_a.query(np.asarray(fake_a))))
        for key, v in {**m, "loss_D_A": loss_da, "loss_D_B": loss_db}.items():
            losses[key].append(float(v))
        print(f"iteration {k}: {[(key, v[-1]) for key, v in losses.items()]}", flush=True)
        if k == 0:
            fp32 = {f"fp32/{n}": v for n, v in {**_flat("G_A", gA, ("batch_stats",)),
                                                 **_flat("G_B", gB, ("batch_stats",))}.items()}
            fakes = {"fake_a_sampled": np.asarray(fake_a)[0, ::GAN_SAMPLE, ::GAN_SAMPLE],
                     "fake_b_sampled": np.asarray(fake_b)[0, ::GAN_SAMPLE, ::GAN_SAMPLE]}
    meta = dict(GAN_TRAIN, kind="cycle_gan", gan_mode="lsgan", lambda_a=10.0, lambda_b=10.0,
                lambda_idt=0.5, pool_size=50,
                steps=["FP32 iteration", "set_warmup(False)", "QAT iteration"],
                jax=jax.__version__)
    _save(path, meta, **{k: np.asarray(v, np.float32) for k, v in losses.items()},
          **fp32, **fakes, **_flat("G_A", gA), **_flat("G_B", gB))


def _load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _want(prefixes, nets, stats_only=()):
    from frostnet_tpu_torch.quant import model_variables

    out = {}
    for prefix, net in zip(prefixes, nets):
        for k, v in model_variables(net).items():
            if k.startswith("batch_stats/") or (k.startswith("quant/")
                                                and prefix not in stats_only):
                out[f"{prefix}/{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("kind", ["pix2pix", "cycle_gan"])
def test_train_reference_keys_and_shapes(kind):
    """Every BN statistic and observer of the port's nets is in the
    reference, with its shape, after the FP32 iteration (BN) and after the
    last; the losses are finite and the QAT iterations' differ from the
    FP32 one; the sampled outputs are finite, in tanh's range and varied."""
    from chip_smoke import gan_train_nets

    nets = gan_train_nets(kind)
    if kind == "pix2pix":
        ref, names = _load(GAN_PIX2PIX_REFERENCE), PIX2PIX_LOSSES
        final = _want(("G", "D"), nets, stats_only=("D",))
        fp32 = {f"fp32/{k}": s for k, s in final.items() if "/batch_stats/" in k}
        samples = ("frozen_out_sampled",)
        iterations = 3
    else:
        ref, names = _load(GAN_CYCLEGAN_REFERENCE), CYCLEGAN_LOSSES
        final = _want(("G_A", "G_B"), nets[:2])
        fp32 = {f"fp32/{k}": s for k, s in final.items() if "/batch_stats/" in k}
        samples = ("fake_a_sampled", "fake_b_sampled")
        iterations = 2
    got = {k: tuple(v.shape) for k, v in ref.items()
           if k not in names + samples + ("__meta__",)}
    assert got == {**final, **fp32}
    assert sum(k.endswith(".min_val") for k in final) == 58 * (1 if kind == "pix2pix" else 2)
    for k in names:
        assert ref[k].shape == (iterations,) and np.isfinite(ref[k]).all(), k
        assert ref[k][1] != ref[k][0], k
    size = GAN_TRAIN["size"] // GAN_SAMPLE
    for k in samples:
        assert ref[k].shape == (size, size, 3) and np.abs(ref[k]).max() <= 1.0, k
        assert len(np.unique(ref[k])) > 100, k
    meta = json.loads(bytes(ref["__meta__"]).decode())
    assert meta["kind"] == kind and meta["netG"] == GAN_TRAIN["netG"]
    assert all(np.isfinite(v).all() for v in ref.values())


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    which = sys.argv[1:] or ["pix2pix", "cyclegan"]
    if "pix2pix" in which:
        make_pix2pix_reference()
    if "cyclegan" in which:
        make_cyclegan_reference()
