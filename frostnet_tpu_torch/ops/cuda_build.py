"""Build the port's CUDA sources with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``build/frostnet_tpu_torch/<name>-<hash>/lib<name>.so`` under the repository
root, keyed by a hash of the sources and the flags. The build runs at first
use (or from :func:`build`, which starts one ``nvcc`` per source at once) and
needs ``nvcc`` for ``sm_90a``. Nothing here runs at import time.

Numerics flags: ``-fmad=false`` so nvcc contracts no multiply-add on its own
(the kernels write ``__fmaf_rn`` where the reference fuses), and no fast-math
(IEEE division and square root).

The INT8 kernels and the resize are also ``torch.library`` ops, so that
``torch.export`` traces them: :func:`traced` says when a wrapper must call
its op, and :func:`fields` gives an operand set as the op takes it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "frostnet_tpu_torch"
SOURCES = ("int8_matmul", "frost_block", "fake_quant", "int8_conv", "depthwise_int8",
           "resize_bilinear")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / f"{name}-{_digest(name)}" / f"lib{name}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every source in ``names`` that is not built yet, in parallel."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = library_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, error_string, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch)."""
    if err != 0:
        msg = error_string(err)
        raise RuntimeError(f"{what}: CUDA error {err}: {msg.decode() if msg else '?'}")


def traced(x: torch.Tensor) -> bool:
    """Whether a wrapper called on ``x`` is being traced (``torch.export``,
    whose inputs are fake tensors, or a dispatch mode such as the flop
    counter): the wrapper then calls its ``torch.library`` op, which the
    tracer records. Otherwise it launches its kernel directly, off the
    dispatcher's per-call cost."""
    return (type(x) is not torch.Tensor or torch._C._len_torch_dispatch_stack() > 0
            or torch.compiler.is_compiling())


def fields(operands) -> List:
    """An operand dataclass's fields in their order: the op's arguments
    after ``x``, which the op's implementations pass back to the class."""
    return [getattr(operands, f.name) for f in dataclasses.fields(operands)]
