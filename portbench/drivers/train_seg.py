"""Training traffic on a segmenter of the port's seg registry: the QAT step
of ``segmentation/train.py::make_seg_train_step``, the class-weighted
cross-entropy with an ignore label, per-pixel labels with a share of
ignored pixels (``drivers/training.py`` has the rest)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.drivers.training import Hooks, Training


class SegHooks(Hooks):
    def model(self, cell):
        from frostnet_tpu_torch.segmentation.models import get_seg_model

        return get_seg_model(cell.config["model"], num_classes=cell.config["arch"]["num_classes"],
                             dataset=cell.config["dataset"])

    def steps(self, cell):
        from frostnet_tpu_torch.nn.mode import FP32, QAT
        from frostnet_tpu_torch.segmentation.train import make_seg_train_step

        cfg = cell.config
        args = (cfg["class_weights"], cfg["ignore_index"], cfg["arch"]["num_classes"])
        return make_seg_train_step(FP32, *args), make_seg_train_step(QAT, *args)

    def labels(self, cell, gen, shape):
        cfg, dev = cell.config, cell.device
        labels = torch.randint(0, cfg["arch"]["num_classes"], shape[:4], generator=gen, device=dev)
        ignored = torch.rand(shape[:4], generator=gen, device=dev) < cell.traffic["ignore_share"]
        return torch.where(ignored, torch.full_like(labels, cfg["ignore_index"]), labels)

    def loss(self, cell, logits, labels):
        """The class-weighted mean of the pixels' NLL, the ignored pixels left
        out; its two sums over the batch's millions of pixels are taken in
        float64 (float32 sums of 9.4 M terms drift by 1e-5)."""
        cfg = cell.config
        n = logits.shape[-1]
        labels = labels.reshape(-1)
        keep = labels != cfg["ignore_index"]
        w = torch.tensor(cfg["class_weights"], dtype=torch.float32, device=logits.device)
        safe = torch.where(keep, labels, torch.zeros_like(labels))
        nll = -F.log_softmax(logits.reshape(-1, n), dim=-1).gather(1, safe[:, None])[:, 0]
        wt = torch.where(keep, w[safe], torch.zeros((), device=w.device)).to(torch.float64)
        return ((nll.to(torch.float64) * wt).sum() / wt.sum()).to(torch.float32)


DRIVER = Training(SegHooks())
run = DRIVER.run
