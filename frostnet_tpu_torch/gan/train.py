"""Style-transfer QAT trainer (``frostnet_tpu/gan/train.py``; reference
Style_Transfer/train.py:29-116).

StatAssist FP32 warm-up epochs -> the generator optimizer leaves warm-up
(``set_warmup(False)``) -> QAT epochs in which the generators fake-quantize.
Only the generators get the GradBoost QAdam (pix2pix_model.py:68-70; one
joint QAdam over both CycleGAN generators); the discriminators use plain
Adam. Both read the reference's ``linear`` lr policy
(:func:`_gan_lr_schedule`). ``latest_G`` / ``latest_D`` (CycleGAN:
``latest_G_A``, ``latest_G_B``, ``latest_D_A``, ``latest_D_B`` and
``latest_opt_G``, the joint optimizer) and ``gan_meta.json`` are written
every ``save_epoch_freq`` QAT epochs and at the end; ``--continue_train``
resumes from them.

Both packages start from ``numpy_init(nets, seed, init="gan")`` here, the
GAN init drawn with numpy in key order. The trainer runs on the card unless
``--device cpu`` is given. Under ``torchrun`` it runs JAX's mesh,
``make_dp_mesh(batch_size)``: the largest divisor of the batch that fits
the ranks (batch 1, the published setting, takes one; the other ranks
idle until the run ends). Each rank trains on its rows with the global
batch's BN statistics and observers and the gradients' mean
(``models.py``); the CycleGAN image pools are one pool, as JAX's host
pools are: every rank gathers the global batch's fakes, queries identical
pools (one seed) on it and keeps its rows, so the pools' numpy draws stay
in JAX's order. Rank 0 alone writes the checkpoints, ``gan_meta.json`` and
the log. Where the JAX trainer writes ``gan_meta.json`` only at
``save_epoch_freq`` epochs, the port also writes it with the final save, so
that a resume starts from the epoch the final checkpoint holds.

Run: python -m frostnet_tpu_torch.gan.train --model pix2pix --dataset synthetic \\
       --netG resnet_9blocks --epochs 1 --fp_epochs 1 --steps_per_epoch 2
     (or torchrun --nproc_per_node 2 -m frostnet_tpu_torch.gan.train ... --batch_size 2)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import torch

from ..nn import FP32, QAT
from ..optim import get_optimizer, set_warmup
from ..optim.schedules import _F32, _fma, _rcp
from ..parallel import Mesh, make_dp_mesh, multihost, rank_rows, replicate, shard_rows
from ..quant import numpy_init
from ..quant.freeze import resolve_device
from ..utils.checkpoint import (restore_checkpoint, restore_optimizer, save_checkpoint,
                                save_optimizer)
from ..utils.logging import MetricLogger
from .data import AlignedDataset, SyntheticPairs, UnalignedDataset, apply_direction
from .image_pool import ImagePool
from .models import (make_cyclegan_steps, make_joint_optimizer, make_net_state,
                     make_pix2pix_steps)
from .networks import define_d, define_g


@dataclasses.dataclass
class GANConfig:
    model: str = "pix2pix"       # 'pix2pix' | 'cycle_gan'
    dataset: str = "synthetic"   # synthetic | colorization | a folder dataset
    data_root: str = "./datasets/facades"
    netG: str = "resnet_6blocks"
    netD: str = "basic"          # basic | n_layers | pixel
    n_layers_d: int = 3          # --n_layers_D (with netD=n_layers)
    ngf: int = 64
    ndf: int = 64
    gan_mode: str = "lsgan"
    norm: Optional[str] = None   # discriminator norm: batch (pix2pix default) | none (cyclegan)
    direction: str = "AtoB"      # AtoB | BtoA (BtoA swaps the domains)
    crop_size: int = 256
    load_size: int = 286
    batch_size: int = 1
    epochs: int = 2
    fp_epochs: int = 1           # --fp_warmup
    lr: float = 2e-4
    beta1: float = 0.5
    lambda_l1: float = 100.0
    lambda_a: float = 10.0
    lambda_b: float = 10.0
    lambda_idt: float = 0.5
    pool_size: int = 50
    save_epoch_freq: int = 5     # save latest_* every N QAT epochs
    n_epochs_decay: int = 0      # linear lr policy: decay to ~0 over this many more epochs
    q_optim: bool = True         # GradBoost QAdam on G
    clip_by: float = 1e-3
    steps_per_epoch: Optional[int] = None
    seed: int = 0
    save_dir: str = "./runs/gan"
    continue_train: bool = False  # load latest_* and keep training
    device: str = "cuda"         # "cpu" runs the kernels' plain versions


def _dataset(cfg: GANConfig):
    if cfg.dataset == "synthetic":
        return SyntheticPairs(cfg.crop_size, cfg.batch_size * (cfg.steps_per_epoch or 4),
                              cfg.batch_size, cfg.seed)
    if cfg.dataset == "colorization":
        from .data import ColorizationDataset

        return ColorizationDataset(cfg.data_root, "train", cfg.batch_size,
                                   cfg.load_size, cfg.crop_size, cfg.seed)
    if cfg.model == "cycle_gan":
        return UnalignedDataset(cfg.data_root, "train", cfg.batch_size,
                                cfg.load_size, cfg.crop_size, cfg.seed)
    return AlignedDataset(cfg.data_root, "train", cfg.batch_size,
                          cfg.load_size, cfg.crop_size, cfg.seed)


def _gan_lr_schedule(cfg: GANConfig, steps_per_epoch: int):
    """The reference's ``linear`` lr policy (networks.py:143-147): ``lr`` for
    the FP32 warm-up and ``cfg.epochs`` QAT epochs, then a linear decay over
    ``cfg.n_epochs_decay`` more, stepped per epoch. A float when there is no
    decay, else a host function ``count -> lr`` giving the float32 value of
    the jitted JAX schedule (XLA's program: integer epoch arithmetic, the
    division a multiply by ``f32(1 / (decay + 1))``, ``1 - x * r`` one fused
    multiply-add, the clip, the multiply by ``f32(lr)``)."""
    if cfg.n_epochs_decay <= 0:
        return cfg.lr
    warm = cfg.fp_epochs * steps_per_epoch
    inv, lr = _rcp(cfg.n_epochs_decay + 1.0), _F32(cfg.lr)

    def sched(count: int) -> float:
        qat_epoch = max(int(count) - warm, 0) // steps_per_epoch + 1
        over = max(_F32(qat_epoch - cfg.epochs), _F32(0.0))
        mult = _fma(-over, inv, 1.0)
        return float(_F32(min(max(mult, _F32(0.0)), _F32(1.0))) * lr)

    return sched


def _g_optimizer(cfg: GANConfig, lr=None):
    """The generator optimizer's factory: QAdam (b1 ``beta1``, ``clip_by``,
    the noise seeded with ``seed``) or Adam."""
    lr = cfg.lr if lr is None else lr
    if cfg.q_optim:
        return get_optimizer("QAdam", lr, b1=cfg.beta1, clip_by=cfg.clip_by, seed=cfg.seed)
    return get_optimizer("Adam", lr, b1=cfg.beta1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _epoch_record(tag, epoch, rows, n_images, seconds, step_ms):
    keys = rows[0].keys() if rows else ()
    stacked = {k: torch.stack([r[k] for r in rows]).cpu().tolist() for k in keys}
    return {"tag": tag, "epoch": epoch, "losses": stacked,
            "last": {k: v[-1] for k, v in stacked.items()},
            "images_per_sec": n_images / max(seconds, 1e-9), "step_ms": step_ms}


def _iterations(ds, cfg: GANConfig):
    for i, batch in enumerate(ds):
        if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
            break
        yield apply_direction(batch, cfg.direction)


def _read_meta(path: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return json.load(f).get("qat_epoch", 0)


def _write_meta(path: str, qat_epoch: int) -> None:
    with open(path, "w") as f:
        json.dump({"qat_epoch": qat_epoch}, f)


def train_pix2pix(cfg: GANConfig, logger, device, mesh: Optional[Mesh] = None):
    """FP32 warm-up, ``set_warmup(False)``, QAT; returns ``(g_state, d_state,
    history)``. Under a data-parallel ``mesh`` this rank trains on its rows
    and only rank 0 writes."""
    ds = rank_rows(_dataset(cfg), mesh)
    primary = multihost.is_primary()
    in_nc, out_nc = (1, 2) if cfg.dataset == "colorization" else (3, 3)
    net_g = define_g(output_nc=out_nc, ngf=cfg.ngf, netG=cfg.netG, quantized=True,
                     input_nc=in_nc)
    net_d = define_d(ndf=cfg.ndf, netD=cfg.netD, n_layers=cfg.n_layers_d,
                     norm=cfg.norm or "batch", input_nc=in_nc + out_nc)
    g_vars, d_vars = numpy_init((net_g, net_d), cfg.seed, init="gan")
    lr = _gan_lr_schedule(cfg, cfg.steps_per_epoch or len(ds))
    g_state = make_net_state(net_g, _g_optimizer(cfg, lr), cfg.seed, device, g_vars)
    d_state = make_net_state(net_d, get_optimizer("Adam", lr, b1=cfg.beta1), cfg.seed, device,
                             d_vars)

    resumed, start_epoch = False, 0
    meta_path = os.path.join(cfg.save_dir, "gan_meta.json")
    if cfg.continue_train and os.path.exists(os.path.join(cfg.save_dir, "latest_D")):
        restore_checkpoint(os.path.join(cfg.save_dir, "latest_G"), g_state)
        restore_checkpoint(os.path.join(cfg.save_dir, "latest_D"), d_state)
        resumed, start_epoch = True, _read_meta(meta_path)
        logger.info(f"continue_train: restored latest_G/latest_D from {cfg.save_dir} "
                    f"(qat epoch {start_epoch})")
    replicated(mesh, g_state.model, d_state.model)
    history = []

    def save(qat_epoch):
        if not primary:
            return
        save_checkpoint(os.path.join(cfg.save_dir, "latest_G"), g_state)
        save_checkpoint(os.path.join(cfg.save_dir, "latest_D"), d_state)
        _write_meta(meta_path, qat_epoch)

    def run_phase(mode, epochs, tag, start=0):
        d_step, g_step = make_pix2pix_steps(mode, cfg.gan_mode, cfg.lambda_l1, mesh)
        for epoch in range(start, epochs):
            rows, n_images, step_ms = [], 0, []
            _sync(device)
            t0 = last = time.perf_counter()
            for batch in _iterations(ds, cfg):
                md = d_step(g_state, d_state, batch)
                mg = g_step(g_state, d_state, batch)
                rows.append({**md, **mg})
                n_images += batch["A"].shape[0]
                now = time.perf_counter()
                step_ms.append((now - last) * 1e3)
                last = now
            _sync(device)
            rec = _epoch_record(tag, epoch, rows, n_images * _replicas(mesh),
                                time.perf_counter() - t0, step_ms)
            history.append(rec)
            logger.info(f"[{tag} {epoch}] {rec['last']} {rec['images_per_sec']:.2f} images/s")
            if tag == "qat" and cfg.save_epoch_freq > 0 and (epoch + 1) % cfg.save_epoch_freq == 0:
                save(epoch + 1)

    if not resumed:
        run_phase(FP32, cfg.fp_epochs, "fp_warmup")
    set_warmup(g_state.optimizer, False)  # idempotent on a resume
    run_phase(QAT, cfg.epochs + cfg.n_epochs_decay, "qat", start=start_epoch)
    save(cfg.epochs + cfg.n_epochs_decay)
    return g_state, d_state, history


def train_cyclegan(cfg: GANConfig, logger, device, mesh: Optional[Mesh] = None):
    """FP32 warm-up, ``set_warmup(False)`` on the joint optimizer, QAT;
    returns ``((gA, gB), (dA, dB), joint_optimizer, history)``. Under a
    data-parallel ``mesh`` this rank trains on its rows, the pools take the
    global batch's fakes, and only rank 0 writes."""
    ds = rank_rows(_dataset(cfg), mesh)
    primary = multihost.is_primary()
    nets = (define_g(ngf=cfg.ngf, netG=cfg.netG, quantized=True),
            define_g(ngf=cfg.ngf, netG=cfg.netG, quantized=True),
            define_d(ndf=cfg.ndf, netD=cfg.netD, n_layers=cfg.n_layers_d,
                     norm=cfg.norm or "none"),
            define_d(ndf=cfg.ndf, netD=cfg.netD, n_layers=cfg.n_layers_d,
                     norm=cfg.norm or "none"))
    trees = numpy_init(nets, cfg.seed, init="gan")
    lr = _gan_lr_schedule(cfg, cfg.steps_per_epoch or len(ds))
    gA, gB = (make_net_state(n, None, cfg.seed + k, device, t)
              for k, (n, t) in enumerate(zip(nets[:2], trees[:2])))
    dA, dB = (make_net_state(n, get_optimizer("Adam", lr, b1=cfg.beta1), cfg.seed, device, t)
              for n, t in zip(nets[2:], trees[2:]))
    joint = make_joint_optimizer(_g_optimizer(cfg, lr), (gA.model, gB.model))
    pool_a, pool_b = ImagePool(cfg.pool_size, cfg.seed), ImagePool(cfg.pool_size, cfg.seed + 1)

    resumed, start_epoch = False, 0
    meta_path = os.path.join(cfg.save_dir, "gan_meta.json")
    if cfg.continue_train and os.path.exists(os.path.join(cfg.save_dir, "latest_D_B")):
        for name, st in (("latest_G_A", gA), ("latest_G_B", gB), ("latest_D_A", dA),
                         ("latest_D_B", dB)):
            restore_checkpoint(os.path.join(cfg.save_dir, name), st)
        restore_optimizer(os.path.join(cfg.save_dir, "latest_opt_G"), joint)
        resumed, start_epoch = True, _read_meta(meta_path)
        logger.info(f"continue_train: restored all four nets and the joint G optimizer from "
                    f"{cfg.save_dir} (qat epoch {start_epoch})")
    replicated(mesh, gA.model, gB.model, dA.model, dB.model)
    history = []

    def save(qat_epoch):
        if not primary:
            return
        _save_cyclegan(cfg.save_dir, gA, gB, dA, dB, joint)
        _write_meta(meta_path, qat_epoch)

    def run_phase(mode, epochs, tag, start=0):
        g_step, d_step = make_cyclegan_steps(mode, cfg.gan_mode, cfg.lambda_a, cfg.lambda_b,
                                             cfg.lambda_idt, mesh)
        for epoch in range(start, epochs):
            rows, n_images, step_ms = [], 0, []
            _sync(device)
            t0 = last = time.perf_counter()
            for batch in _iterations(ds, cfg):
                fake_a, fake_b, mg = g_step(gA, gB, dA, dB, batch, joint)
                fb = pooled(pool_b, fake_b, mesh)
                fa = pooled(pool_a, fake_a, mesh)
                loss_da = d_step(dA, batch["B"], fb)
                loss_db = d_step(dB, batch["A"], fa)
                rows.append({**mg, "loss_D_A": loss_da, "loss_D_B": loss_db})
                n_images += batch["A"].shape[0]
                now = time.perf_counter()
                step_ms.append((now - last) * 1e3)
                last = now
            _sync(device)
            rec = _epoch_record(tag, epoch, rows, n_images * _replicas(mesh),
                                time.perf_counter() - t0, step_ms)
            history.append(rec)
            logger.info(f"[{tag} {epoch}] {rec['last']} {rec['images_per_sec']:.2f} images/s")
            if tag == "qat" and cfg.save_epoch_freq > 0 and (epoch + 1) % cfg.save_epoch_freq == 0:
                save(epoch + 1)

    if not resumed:
        run_phase(FP32, cfg.fp_epochs, "fp_warmup")
    set_warmup(joint, False)
    run_phase(QAT, cfg.epochs + cfg.n_epochs_decay, "qat", start=start_epoch)
    save(cfg.epochs + cfg.n_epochs_decay)
    return (gA, gB), (dA, dB), joint, history


def pooled(pool: ImagePool, fakes: torch.Tensor, mesh: Optional[Mesh] = None):
    """The pool's answer for this rank's rows of ``fakes``. Under a
    data-parallel mesh every rank gathers the global batch's fakes, queries
    its copy of the pool on them (the copies draw alike: one seed, the same
    images in the same order) and keeps its rows: the one pool of JAX's
    host loop."""
    if mesh is None or not mesh.distributed:
        return pool.query(fakes.cpu().numpy())
    out = pool.query(mesh.dp_gather(fakes).cpu().numpy())
    return out[shard_rows(out.shape[0], mesh.dp, mesh.dp_index)]


def replicated(mesh: Optional[Mesh], *models) -> None:
    """Rank 0's parameters and buffers of ``models`` on every rank."""
    if mesh is not None:
        for m in models:
            replicate(m, mesh)


def _replicas(mesh: Optional[Mesh]) -> int:
    return mesh.dp if mesh is not None and mesh.distributed else 1


def _save_cyclegan(save_dir, gA, gB, dA, dB, joint) -> None:
    """All four nets and the joint generator optimizer."""
    for name, st in (("latest_G_A", gA), ("latest_G_B", gB), ("latest_D_A", dA),
                     ("latest_D_B", dB)):
        save_checkpoint(os.path.join(save_dir, name), st)
    save_optimizer(os.path.join(save_dir, "latest_opt_G"), joint)


def main(cfg: GANConfig):
    """Train; returns ``(generator states, discriminator states, results)``
    with each epoch's per-iteration losses, images/s and step times in
    ``results["history"]``. A rank beyond the data-parallel mesh returns
    ``((), (), {"history": [], "idle": True})`` at the run's end."""
    multihost.initialize(cfg.device)  # torchrun's ranks; a no-op in one process
    mesh = make_dp_mesh(cfg.batch_size)  # JAX's mesh: the largest divisor that fits
    if not mesh.member:
        multihost.wait_for_end(mesh)
        return (), (), {"history": [], "idle": True}
    device = resolve_device(multihost.local_device(cfg.device))
    primary = multihost.is_primary()
    os.makedirs(cfg.save_dir, exist_ok=True)
    logger = (MetricLogger(cfg.save_dir, name="gan") if primary
              else MetricLogger(None, name="gan", echo=False))
    logger.info(f"config: {dataclasses.asdict(cfg)}")
    logger.info(f"mesh {mesh.shape}, device {device}")
    if cfg.model == "pix2pix":
        g, d, history = train_pix2pix(cfg, logger, device, mesh)
        gs, ds = (g,), (d,)
    elif cfg.model == "cycle_gan":
        gs, ds, _, history = train_cyclegan(cfg, logger, device, mesh)
    else:
        raise ValueError(f"unknown model {cfg.model!r}")
    for rec in history:
        logger.log_scalars({f"{rec['tag']}/{k}": v for k, v in rec["last"].items()},
                           step=rec["epoch"])
    logger.info("done")
    logger.close()
    multihost.wait_for_end(mesh)
    return gs, ds, {"history": history}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for f in dataclasses.fields(GANConfig):
        kind = {"int": int, "float": float, "Optional[int]": int,
                "bool": lambda s: s.lower() in ("1", "true")}.get(f.type, str)
        p.add_argument(f"--{f.name}", type=kind, default=None)
    return p


def config_from_args(args) -> GANConfig:
    cfg = GANConfig()
    for f in dataclasses.fields(GANConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    return cfg


def cli(argv=None):
    main(config_from_args(build_parser().parse_args(argv)))


if __name__ == "__main__":
    cli()
