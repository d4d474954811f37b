"""The INT8 artifact of the JAX package, written and read by the port.

``frostnet_tpu.quant.export_int8`` writes one flat npz: every observed conv
kernel as int8 with BN pre-folded (BN neutralized to gamma 1, mean 0,
var 1-eps), observers as ``quant/<path>/<name>.min_val|max_val``, and a
``__meta__`` JSON with the qconfig. :func:`export_int8` writes the same
layout and keys, with the same arrays, from a port model (a trained one:
the artifact of a port run); :func:`load_int8` reads it into the
JAX variables tree (numpy leaves, int8 kernels dequantized on their
observer's grid), and :func:`from_jax_variables` fills a port model from any
such tree, parameters and buffers alike. ``freeze`` then repeats the JAX
chain op for op: dequantize here, ``fold_bn``, ``calculate_qparams_folded``
and ``quantize`` at freeze time. :func:`numpy_init` makes a fresh variables
tree from a seed with numpy, so that both packages can start training from
the same weights.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from .fake_quant import dequantize, quantize
from .folding import fold_bn
from .observer import ObserverState, calculate_qparams_folded
from .qtypes import FBGEMM, QNNPACK, QConfig

_QCONFIGS = {"qnnpack": QNNPACK, "fbgemm": FBGEMM}
_OBS_LEAVES = ("min_val", "max_val")
_BN_STATS = ("mean", "var")


def _channel_axis(w: np.ndarray, obs: ObserverState) -> Optional[int]:
    """Axis of ``w`` carrying the per-channel qparams, or None (per-tensor)."""
    if np.ndim(obs.min_val) == 0:
        return None
    n = obs.min_val.shape[0]
    for ax in range(w.ndim - 1, -1, -1):  # prefer trailing axes (HWIO)
        if w.shape[ax] == n:
            return ax
    raise ValueError(f"no axis of {w.shape} matches per-channel size {n}")


def artifact_qconfig(path: str) -> QConfig:
    """The qconfig an artifact was exported with (its ``__meta__``)."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    return _QCONFIGS.get(meta.get("qconfig", "qnnpack"), QNNPACK)


def export_int8(model_or_variables, path: str, qconfig: Optional[QConfig] = None,
                bn_eps: float = 1e-5) -> int:
    """Write the INT8 artifact of a port model (or of a ``{params,
    batch_stats, quant}`` tree) at ``path`` (.npz); returns the bytes written.

    The observers must be populated (QAT or ``train.recalibrate`` first).
    ``qconfig`` defaults to the model's (QNNPACK for a tree). The arithmetic
    is the JAX export's, which runs op by op: ``fold_bn`` with separate
    roundings, the folded qparams with IEEE division, ``quantize`` of the
    folded kernel on the weight observer's grid. The inverse of
    :func:`load_int8`.
    """
    if isinstance(model_or_variables, nn.Module):
        if qconfig is None:
            qconfig = getattr(getattr(model_or_variables, "quant", None), "qconfig", None)
        flat = {k: v.detach().cpu().numpy() for k, v in model_variables(model_or_variables).items()}
    else:
        flat = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in flatten_variables(model_or_variables).items()}
    qconfig = qconfig or QNNPACK
    tree = unflatten_variables(flat)
    wspec = qconfig.weight
    out: Dict[str, np.ndarray] = {}
    t = torch.as_tensor

    def put(col: str, prefix: str, name: str, arr):
        out[f"{col}/{prefix}{name}"] = np.asarray(arr)

    def walk(p: Dict, bs: Dict, q: Dict, prefix: str):
        handled = set()
        if "kernel" in p and isinstance(q.get("w_obs"), ObserverState):
            w, obs = np.asarray(p["kernel"], np.float32), q["w_obs"]
            has_bn = "scale" in p and "bias_bn" in p and "mean" in bs and "var" in bs
            if has_bn:
                wf, bf = fold_bn(t(w), None if p.get("bias") is None else t(p["bias"]),
                                 t(p["scale"]), t(p["bias_bn"]), t(bs["mean"]), t(bs["var"]),
                                 bn_eps)
                wf, bf = wf.numpy(), bf.numpy()
            else:
                wf, bf = w, None
            ch = _channel_axis(wf, obs)
            scale, zp = calculate_qparams_folded(ObserverState(t(obs.min_val), t(obs.max_val)),
                                                 wspec)
            put("params", prefix, "kernel",
                quantize(t(wf), scale, zp, wspec, ch).numpy().astype(np.int8))
            handled.add("kernel")
            if has_bn:
                f = np.shape(p["bias_bn"])
                put("params", prefix, "scale", np.ones(f, np.float32))
                put("params", prefix, "bias_bn", np.asarray(bf, np.float32))
                put("batch_stats", prefix, "mean", np.zeros(f, np.float32))
                put("batch_stats", prefix, "var", np.full(f, 1.0 - bn_eps, np.float32))
                handled.update(("scale", "bias_bn"))
                if "bias" in p:  # folded into bias_bn
                    put("params", prefix, "bias", np.zeros_like(np.asarray(p["bias"])))
                    handled.add("bias")
        for k, v in p.items():
            if k in handled:
                continue
            if isinstance(v, dict):
                walk(v, bs.get(k, {}), q.get(k, {}), f"{prefix}{k}/")
            else:
                put("params", prefix, k, v)
        for k, v in bs.items():
            if not isinstance(v, dict) and f"batch_stats/{prefix}{k}" not in out:
                put("batch_stats", prefix, k, v)

    quant = tree.get("quant", {})
    walk(tree.get("params", {}), tree.get("batch_stats", {}), quant, "")
    out.update({k: v for k, v in flatten_variables({"quant": quant}).items()})
    out["__meta__"] = np.frombuffer(
        json.dumps({"qconfig": "fbgemm" if qconfig is FBGEMM else "qnnpack",
                    "bn_eps": bn_eps}).encode(), dtype=np.uint8)
    if not path.endswith(".npz"):
        path += ".npz"
    with open(path, "wb") as f:
        np.savez(f, **out)
    return os.path.getsize(path)


def load_int8(path: str, qconfig: Optional[QConfig] = None) -> Dict[str, Any]:
    """Load an ``export_int8`` artifact into a ``{params, batch_stats, quant}``
    tree of numpy arrays (observers as :class:`ObserverState`)."""
    if not path.endswith(".npz"):
        path += ".npz"
    qconfig = qconfig or artifact_qconfig(path)
    wspec = qconfig.weight
    with np.load(path) as data:
        tree = unflatten_variables({k: data[k] for k in data.files if k != "__meta__"})
    quant = tree.get("quant", {})

    def fix_params(p: Dict, q: Dict) -> Dict:
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = fix_params(v, q.get(k, {}))
            elif k == "kernel" and v.dtype == np.int8:
                obs = q["w_obs"]
                ch = _channel_axis(v, obs)
                st = ObserverState(torch.as_tensor(obs.min_val), torch.as_tensor(obs.max_val))
                scale, zp = calculate_qparams_folded(st, wspec)
                out[k] = dequantize(torch.as_tensor(v).to(torch.int32), scale, zp, ch).numpy()
            else:
                out[k] = v
        return out

    return {"params": fix_params(tree.get("params", {}), quant),
            "batch_stats": tree.get("batch_stats", {}), "quant": quant}


def flatten_variables(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX variables tree -> ``{"params/a/b/kernel": array, ...}``.

    Observers become ``quant/<path>/<name>.min_val`` and ``.max_val`` leaves,
    the key format of the INT8 artifact. Accepts ObserverState tuples or
    ``{min_val, max_val}`` dicts.
    """
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, ObserverState) or (
                hasattr(node, "_fields") and tuple(node._fields) == _OBS_LEAVES):
            flat[f"{prefix[:-1]}.min_val"] = np.asarray(node[0])
            flat[f"{prefix[:-1]}.max_val"] = np.asarray(node[1])
        elif isinstance(node, dict) and set(node) == set(_OBS_LEAVES) and prefix.startswith("quant/"):
            flat[f"{prefix[:-1]}.min_val"] = np.asarray(node["min_val"])
            flat[f"{prefix[:-1]}.max_val"] = np.asarray(node["max_val"])
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = np.asarray(node)

    for col in ("params", "batch_stats", "quant"):
        walk(tree.get(col, {}), f"{col}/")
    return flat


def variable_key(buffer_name: str) -> str:
    """A port parameter or buffer name -> its key in the flat JAX layout.

    ``layer3_1.conv2.kernel`` -> ``params/layer3_1/conv2/kernel``;
    ``...mean`` -> ``batch_stats/...``; an observer's
    ``layer3_1.conv2.w_obs.min_val`` -> ``quant/layer3_1/conv2/w_obs.min_val``.
    """
    parts = buffer_name.split(".")
    if parts[-1] in _OBS_LEAVES:
        return "quant/" + "/".join(parts[:-1]) + "." + parts[-1]
    col = "batch_stats" if parts[-1] in _BN_STATS else "params"
    return col + "/" + "/".join(parts)


def model_variables(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers under their flat JAX keys."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {variable_key(name): t for name, t in named}


def from_jax_variables(model, tree):
    """Fill ``model``'s parameters and buffers from a JAX
    ``{params, batch_stats, quant}`` tree.

    Every variable must be present with its shape, and every leaf of the
    tree must land in one. Returns the model. A tuple of models takes a
    tuple of trees, one each: a detector's ``(feat, head)`` from the JAX
    package's ``(feat_vars, head_vars)``, pix2pix's ``(G, D)``, CycleGAN's
    ``(G_A, G_B, D_A, D_B)`` (a float discriminator's tree has no
    ``quant``, and none without BN a ``batch_stats``).
    """
    if isinstance(model, (tuple, list)):
        if len(model) != len(tree):
            raise ValueError(f"{len(model)} models, {len(tree)} variable trees")
        return tuple(from_jax_variables(m, t) for m, t in zip(model, tree))
    flat = flatten_variables(tree)
    mine = model_variables(model)
    missing = sorted(set(mine) - set(flat))
    extra = sorted(set(flat) - set(mine))
    if missing or extra:
        raise ValueError(f"variables do not match the model: missing {missing[:5]}"
                         f"{'...' if len(missing) > 5 else ''}, unexpected {extra[:5]}"
                         f"{'...' if len(extra) > 5 else ''}")
    with torch.no_grad():
        for key, buf in mine.items():
            src = torch.from_numpy(np.array(flat[key], np.float32))
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(buf.shape)}")
            buf.copy_(src)
    return model


def unflatten_variables(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`flatten_variables`: a ``{params, batch_stats,
    quant}`` tree, observers as :class:`ObserverState` pairs."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def observers(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = observers(v)
            elif k.endswith(".min_val"):
                name = k[:-len(".min_val")]
                out[name] = ObserverState(v, node[f"{name}.max_val"])
        return out

    if "quant" in tree:
        tree["quant"] = observers(tree["quant"])
    return tree


def numpy_init(model, seed: int = 0, init: str = "kaiming"):
    """A fresh ``{params, batch_stats, quant}`` tree for ``model``, from numpy
    (a tuple of trees for a tuple of models, drawn from one generator in
    turn: a GAN's ``(G, D)`` or ``(G_A, G_B, D_A, D_B)``).

    The JAX package's initial values, drawn with ``np.random.RandomState(seed)``
    in sorted key order: conv kernels kaiming-normal with fan-out
    (``frostnet_tpu/nn/conv.py`` ``variance_scaling(2, "fan_out", "normal")``:
    std ``sqrt(2 / (kh * kw * out))``, float32), the dense classifiers of
    the float-only baselines and the ESPNetv2 classifier
    (``classifier_kernel``, ``fc_kernel``: (in, out)) LeCun-normal (std
    ``sqrt(1 / in)``), BN scales and running variances 1, biases and running
    means 0, observers at (+inf, -inf).
    ``init="gan"`` draws the GAN networks' init instead
    (``frostnet_tpu/gan/networks.py:28-37``): kernels ``N(0, 0.02)`` and BN
    scales ``1 + 0.02 N``, each a standard normal draw in key order.
    """
    if init not in ("kaiming", "gan"):
        raise ValueError(f"init must be kaiming|gan, got {init!r}")
    rng = np.random.RandomState(seed)
    if isinstance(model, (tuple, list)):
        return tuple(_numpy_init(m, rng, init) for m in model)
    return _numpy_init(model, rng, init)


def _numpy_init(model: nn.Module, rng: np.random.RandomState, init: str) -> Dict[str, Any]:
    flat: Dict[str, np.ndarray] = {}
    for key, t in sorted(model_variables(model).items()):
        shape = tuple(t.shape)
        leaf = key.rsplit("/", 1)[1]
        if leaf.endswith(".min_val"):
            flat[key] = np.full(shape, np.inf, np.float32)
        elif leaf.endswith(".max_val"):
            flat[key] = np.full(shape, -np.inf, np.float32)
        elif leaf == "kernel":
            std = 0.02 if init == "gan" else np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
            flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
        elif leaf.endswith("_kernel"):  # a dense (in, out) classifier: LeCun normal
            flat[key] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        elif leaf == "scale" and init == "gan" and key.startswith("params/"):
            flat[key] = (1.0 + 0.02 * rng.standard_normal(shape)).astype(np.float32)
        elif leaf in ("scale", "var"):
            flat[key] = np.ones(shape, np.float32)
        else:
            flat[key] = np.zeros(shape, np.float32)
    return unflatten_variables(flat)
