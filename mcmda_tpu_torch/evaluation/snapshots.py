"""Qualitative prediction snapshots (counterpart of
``mcmda_tpu/evaluation/snapshots.py``): a PNG grid per call, input slice |
prediction overlay | (optional) ground-truth overlay, with the 4 structures
colour-coded.

The JAX package writes the PNG with PIL; the port writes it with the
standard library (``zlib`` and ``struct``), so it runs where PIL is not
installed: 8-bit RGB, filter 0 on every row, one IDAT chunk.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# class colours: bg, AA, LAC, LVC, MYO
_COLORS = np.array([[0, 0, 0], [220, 60, 60], [60, 150, 220],
                    [240, 200, 60], [120, 210, 120]], np.uint8)


def _to_u8(img2d: np.ndarray) -> np.ndarray:
    lo, hi = np.percentile(img2d, [1, 99])
    x = np.clip((img2d - lo) / (hi - lo + 1e-8), 0, 1)
    return (x * 255).astype(np.uint8)


def _overlay(gray_u8: np.ndarray, labels: np.ndarray,
             alpha=0.45) -> np.ndarray:
    rgb = np.stack([gray_u8] * 3, -1).astype(np.float32)
    color = _COLORS[np.clip(labels, 0, len(_COLORS) - 1)].astype(np.float32)
    mask = (labels > 0)[..., None]
    out = np.where(mask, (1 - alpha) * rgb + alpha * color, rgb)
    return out.astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(rgb: np.ndarray) -> bytes:
    """An [H,W,3] uint8 image as PNG file bytes."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                          1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_snapshot(path: str, images: np.ndarray, preds: np.ndarray,
                  truths: np.ndarray | None = None, max_rows: int = 4) -> str:
    """images [N,H,W] or [N,H,W,C] (the centre channel is shown), preds
    [N,H,W] int, truths optional [N,H,W] int.  Writes a PNG grid; returns
    the path."""
    if images.ndim == 4:
        images = images[..., images.shape[-1] // 2]
    n = min(max_rows, images.shape[0])
    cols = []
    for i in range(n):
        g = _to_u8(np.asarray(images[i]))
        row = [np.stack([g] * 3, -1), _overlay(g, np.asarray(preds[i]))]
        if truths is not None:
            row.append(_overlay(g, np.asarray(truths[i])))
        cols.append(np.concatenate(row, axis=1))
    grid = np.concatenate(cols, axis=0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(grid))
    return path
