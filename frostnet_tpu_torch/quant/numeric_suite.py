"""Per-layer quantization error report (``frostnet_tpu/quant/numeric_suite.py``).

When the QAT and INT8 accuracies disagree, this names the layer: the same
model's variables run in two modes, every module's output is captured, and
each layer gets its signal-to-quantization-noise ratio (SQNR) and its worst
error in output quanta, worst first.

Capture: forward hooks take the place of flax's ``capture_intermediates``.
A module's path is its JAX name (``layer4_1/conv2``; the model itself is
``<output>``). A module called more than once keeps every call, suffixed
``#i``, and so does each element of a tuple or list output.

The INT8 pass runs frozen, as every INT8 forward of the port does
(``prepare_int8``), on an unfused copy of the model: under ``fuse_int8`` a
Frost block is one kernel with no inner modules, while the JAX package
runs INT8 unfused, with every module called. So the report covers each
block's inner convs and joins, as JAX's does; the model passed in is not
touched.

Usage::

    from frostnet_tpu_torch.quant.numeric_suite import compare_modes, format_report
    rows = compare_modes(model, x)      # QAT_FROZEN vs INT8
    print(format_report(rows, 5))

or ``python -m frostnet_tpu_torch.quant.numeric_suite --model frostnet_quant_small_1_0``.
"""
from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..nn.mode import INT8, QAT_FROZEN, QuantMode
from .qtensor import QTensor


@dataclasses.dataclass
class LayerReport:
    path: str             # module path, e.g. layer4_1/conv2
    shape: tuple
    sqnr_db: float        # 10*log10(|ref|^2 / |ref-test|^2); inf if exact
    max_abs: float        # worst absolute error (dequantized units)
    max_quanta: Optional[float]  # worst error / output scale (INT8 side)
    scale: Optional[float]       # test-side output scale, if quantized


def _walk(node, prefix: str, out: Dict[str, object]) -> None:
    """Flatten one module's calls (a tuple) into ``{path[#i]: output}``."""
    if isinstance(node, (QTensor, torch.Tensor)):  # QTensor (a tuple) first
        out[prefix or "<output>"] = node
    elif isinstance(node, (tuple, list)):
        many = len(node) > 1
        for i, v in enumerate(node):
            _walk(v, f"{prefix}#{i}" if many else prefix, out)


def _capture(model, x: torch.Tensor, mode: QuantMode) -> Dict[str, object]:
    """Every module's outputs of one forward in ``mode``."""
    calls: Dict[str, list] = {}
    hooks = []
    for name, mod in model.named_modules():
        def hook(_mod, _inp, output, name=name.replace(".", "/")):
            calls.setdefault(name, []).append(output)
        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(x, mode=mode)
    finally:
        for h in hooks:
            h.remove()
    out: Dict[str, object] = {}
    for name, outputs in calls.items():
        _walk(tuple(outputs), name, out)
    return out


def _dequant(v):
    if isinstance(v, QTensor):
        return (v.dequantize().detach().cpu().numpy().astype(np.float32),
                float(v.scale.detach().cpu().max()))
    return v.detach().to(torch.float32).cpu().numpy(), None


def compare_modes(model, x, ref_mode: QuantMode = QAT_FROZEN,
                  test_mode: QuantMode = INT8) -> List[LayerReport]:
    """Per-layer outputs of ``test_mode`` against ``ref_mode``, worst SQNR first.

    ``model`` holds calibrated variables (observers populated); ``x`` is
    (B, S, S, 3) float images, numpy or a tensor. Both passes run on the
    device of ``model``'s parameters, on an unfused copy frozen for ``x``'s
    size where a pass is INT8. INT8 outputs are dequantized onto the float
    grid, so an exact conversion reports ``sqnr_db = inf`` and
    ``max_quanta = 0`` on every layer.
    """
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray) else x)
    x = x.to(device=device, dtype=torch.float32)
    # the fused blocks' frozen operands (their launch plans hold ctypes
    # arguments, which do not copy) are left out: the copy runs unfused
    memo = {id(m._params): None for m in model.modules() if hasattr(m, "_params")}
    net = copy.deepcopy(model, memo).eval()
    for mod in net.modules():
        if hasattr(mod, "fuse_int8"):
            mod.fuse_int8 = False
    if ref_mode.int8 or test_mode.int8:
        net.prepare_int8(device, x.shape[1])
    ref, test = _capture(net, x, ref_mode), _capture(net, x, test_mode)
    unmatched = sorted(set(ref) ^ set(test))
    rows, skipped = [], []
    for name in sorted(set(ref) & set(test)):
        r, _ = _dequant(ref[name])
        t, scale = _dequant(test[name])
        if r.shape != t.shape:
            skipped.append(name)
            continue
        err = r - t
        num = float((r.astype(np.float64) ** 2).sum())
        den = float((err.astype(np.float64) ** 2).sum())
        sqnr = float("inf") if den == 0 else 10.0 * np.log10(max(num, 1e-30) / den)
        max_abs = float(np.abs(err).max())
        rows.append(LayerReport(path=name, shape=tuple(t.shape), sqnr_db=sqnr, max_abs=max_abs,
                                max_quanta=(max_abs / scale) if scale else None, scale=scale))
    if unmatched or skipped:
        # a silent loss of coverage would read as "everything healthy"
        warnings.warn(f"numeric_suite: {len(unmatched)} layer(s) present in only one mode "
                      f"{unmatched[:5]}, {len(skipped)} shape-mismatched {skipped[:5]} — "
                      "excluded from the report")
    rows.sort(key=lambda r: r.sqnr_db)
    return rows


def format_report(rows: List[LayerReport], top: Optional[int] = None) -> str:
    lines = [f"{'layer':40s} {'shape':>18s} {'SQNR dB':>8s} {'max|err|':>10s} {'quanta':>7s}"]
    for r in rows[:top]:
        q = f"{r.max_quanta:.1f}" if r.max_quanta is not None else "-"
        s = f"{r.sqnr_db:.1f}" if np.isfinite(r.sqnr_db) else "inf"
        lines.append(f"{r.path:40s} {str(r.shape):>18s} {s:>8s} {r.max_abs:>10.4g} {q:>7s}")
    return "\n".join(lines)


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="frostnet_quant_small_1_0")
    p.add_argument("--checkpoint", default=None,
                   help="trainer checkpoint dir; random init + synthetic calibration when "
                        "omitted")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--calib_batches", type=int, default=2)
    p.add_argument("--top", type=int, default=None, help="print the worst N only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(args) -> List[LayerReport]:
    from ..models import create_model
    from ..train.state import create_train_state, recalibrate
    from ..utils.checkpoint import restore_model_variables

    model = create_model(args.model, num_classes=args.num_classes, image_size=args.image_size)
    state = create_train_state(model, None, seed=args.seed, device=args.device)
    rng = np.random.RandomState(args.seed)
    shape = (args.batch_size, args.image_size, args.image_size, 3)
    if args.checkpoint:
        restore_model_variables(args.checkpoint, state)
    else:
        # calibrate the observers so that the INT8 grids mean something
        recalibrate(state, [{"image": rng.randn(*shape).astype(np.float32)}
                            for _ in range(args.calib_batches)])
    rows = compare_modes(model, rng.randn(*shape).astype(np.float32))
    print(format_report(rows, args.top))
    return rows


def cli(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
