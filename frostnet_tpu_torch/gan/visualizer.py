"""Training visuals: PNG dumps and a static HTML gallery
(``frostnet_tpu/gan/visualizer.py``; reference util/visualizer.py and
util/html.py without visdom or dominate).

The gallery writes 8-bit RGB PNGs with the standard library (``zlib`` and
``struct``: :func:`write_png`), so it needs no PIL; the files and their
pixels are those the JAX package's PIL writer gives.
"""
from __future__ import annotations

import html
import os
import struct
import zlib
from typing import Dict

import numpy as np


def tensor2im(x) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8 HWC (the first batch element)."""
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    return ((np.clip(x, -1, 1) + 1) / 2 * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W, 3) RGB or (H, W) grey image as a PNG: one IDAT
    of filter-0 scanlines, deflated."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes (H, W), (H, W, 1) or (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


class HTMLGallery:
    """Static gallery writer (util/html.py equivalent)."""

    def __init__(self, web_dir: str, title: str = "frostnet_tpu GAN"):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.title = title
        self.rows = []

    def add_images(self, visuals: Dict[str, np.ndarray], prefix: str):
        cells = []
        for name, img in visuals.items():
            fname = f"{prefix}_{name}.png"
            write_png(os.path.join(self.img_dir, fname), tensor2im(img))
            cells.append((name, f"images/{fname}"))
        self.rows.append((prefix, cells))
        self._write()

    def _write(self):
        parts = [f"<html><head><title>{html.escape(self.title)}</title></head><body>",
                 f"<h1>{html.escape(self.title)}</h1>"]
        for prefix, cells in reversed(self.rows):
            parts.append(f"<h3>{html.escape(prefix)}</h3><table><tr>")
            for name, rel in cells:
                parts.append(
                    f"<td style='text-align:center'><img src='{rel}' "
                    f"style='max-width:256px'><br>{html.escape(name)}</td>")
            parts.append("</tr></table>")
        parts.append("</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write("\n".join(parts))


class Visualizer:
    """Loss logging and periodic image snapshots (util/visualizer.py)."""

    def __init__(self, save_dir: str, name: str = "experiment"):
        self.gallery = HTMLGallery(os.path.join(save_dir, "web"), name)
        self.loss_log = os.path.join(save_dir, "loss_log.txt")
        os.makedirs(save_dir, exist_ok=True)

    def display_current_results(self, visuals: Dict[str, np.ndarray], epoch: int):
        self.gallery.add_images(visuals, f"epoch{epoch:03d}")

    def print_current_losses(self, epoch: int, iters: int, losses: Dict[str, float]):
        msg = f"(epoch: {epoch}, iters: {iters}) " + " ".join(
            f"{k}: {v:.3f}" for k, v in losses.items())
        print(msg, flush=True)
        with open(self.loss_log, "a") as f:
            f.write(msg + "\n")
