"""Serving traffic on a segmenter of the port's seg registry:
``serve.seg_predictor`` (the quant region's float phases in bfloat16, as
the server builds it). The response is the per-pixel class map: the argmax
over the logits on the card, as uint8, copied to the host. Compared are
the class maps of the sampled requests against the reference's argmax
(``map_mismatch``: the largest share of a request's pixels whose class
differs) and the logits behind the class maps of a smaller sample, kept on
the card through the window (``logit_gap``). ``drivers/serving.py`` has
the rest."""
from __future__ import annotations

import torch

from portbench.drivers import common, train_seg
from portbench.drivers.serving import Hooks, Serving, logit_gap


class SegHooks(Hooks):
    keeps_logits = True
    model = train_seg.SegHooks.model

    def predictor(self, cell, artifact):
        from frostnet_tpu_torch.serve import seg_predictor

        return seg_predictor(cell.config["model"], artifact, cell.config["arch"]["num_classes"],
                             common.geometry(cell)[0], device=cell.device)

    def respond(self, out):
        return out.argmax(-1).to(torch.uint8).cpu()

    def checks(self, responses, logits, ref):
        maps = {k: r.argmax(-1).to(torch.uint8) for k, r in ref.items()}
        mismatch = max(float((m != maps[k]).to(torch.float64).mean()) for _, k, m in responses)
        return {"logit_gap": max(logit_gap(out, ref[k]) for _, k, out in logits),
                "map_mismatch": mismatch}


DRIVER = Serving(SegHooks())
run = DRIVER.run
