"""Dependency-free 2D rasterization primitives and a PNG writer
(counterpart of ``hyslam_tpu/viz/draw2d.py``, the same code: pure numpy).

The reference draws with OpenCV/OpenGL (src/viz/FrameDrawer.cc,
MapDrawer.cc); neither is a dependency here, so annotation uses vectorized
numpy splats and segments, and PNGs are encoded directly with zlib.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 5x7 bitmap glyphs for the status text bar (columns LSB=top row)
_FONT = {
    "0": "3E5149453E", "1": "00427F4000", "2": "4261514946", "3": "2141454B31",
    "4": "181412107F", "5": "2745454539", "6": "3C4A494930", "7": "0171090503",
    "8": "3649494936", "9": "064949291E", " ": "0000000000", ":": "0036360000",
    ",": "0056360000", ".": "0060600000", "-": "0808080808", "/": "2010080402",
    "%": "2313086462", "|": "00007F0000", "(": "001C224100", ")": "0041221C00",
    "A": "7E1111117E", "B": "7F49494936", "C": "3E41414122", "D": "7F4141221C",
    "E": "7F49494941", "F": "7F09090901", "G": "3E41495172", "H": "7F0808087F",
    "I": "00417F4100", "J": "2040413F01", "K": "7F08142241", "L": "7F40404040",
    "M": "7F020C027F", "N": "7F0408107F", "O": "3E4141413E", "P": "7F09090906",
    "Q": "3E4151215E", "R": "7F09192946", "S": "4649494931", "T": "01017F0101",
    "U": "3F4040403F", "V": "1F2040201F", "W": "3F4038403F", "X": "6314081463",
    "Y": "0708700807", "Z": "6151494543", "=": "1414141414", "<": "0814224100",
    ">": "0041221408",
}


def _glyph(ch: str) -> np.ndarray:
    """7x5 bool bitmap for one character."""
    hexcols = _FONT.get(ch.upper(), _FONT[" "])
    cols = [int(hexcols[i:i + 2], 16) for i in range(0, 10, 2)]
    g = np.zeros((7, 5), bool)
    for x, c in enumerate(cols):
        for y in range(7):
            g[y, x] = (c >> y) & 1
    return g


def to_numpy(x) -> np.ndarray:
    """x as a numpy array; a tensor, on any device, is read to the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def blank(h: int, w: int, color=(0, 0, 0)) -> np.ndarray:
    img = np.empty((h, w, 3), np.uint8)
    img[:] = np.asarray(color, np.uint8)
    return img


def draw_points(img: np.ndarray, xy: np.ndarray, color, radius: int = 1,
                mask: np.ndarray | None = None) -> None:
    """Splat square markers at xy [N,2] (vectorized, in place)."""
    if xy.size == 0:
        return
    h, w = img.shape[:2]
    xy = np.asarray(xy)
    if mask is not None:
        xy = xy[np.asarray(mask, bool)]
    pts = np.round(xy).astype(np.int64)
    ok = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    pts = pts[ok]
    color = np.asarray(color, np.uint8)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            x = np.clip(pts[:, 0] + dx, 0, w - 1)
            y = np.clip(pts[:, 1] + dy, 0, h - 1)
            img[y, x] = color


def draw_segments(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, color,
                  mask: np.ndarray | None = None) -> None:
    """Batch line segments p0->p1 [N,2] via uniform parameter sampling
    (vectorized; adequate for frusta/graph/trajectory overlays)."""
    p0 = np.asarray(p0, np.float64).reshape(-1, 2)
    p1 = np.asarray(p1, np.float64).reshape(-1, 2)
    if mask is not None:
        m = np.asarray(mask, bool)
        p0, p1 = p0[m], p1[m]
    if len(p0) == 0:
        return
    h, w = img.shape[:2]
    lengths = np.linalg.norm(p1 - p0, axis=-1)
    n_steps = int(min(max(lengths.max(), 1), 4 * max(h, w)))
    t = np.linspace(0.0, 1.0, n_steps)[None, :, None]
    pts = p0[:, None, :] * (1 - t) + p1[:, None, :] * t
    pts = np.round(pts.reshape(-1, 2)).astype(np.int64)
    ok = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    pts = pts[ok]
    img[pts[:, 1], pts[:, 0]] = np.asarray(color, np.uint8)


def draw_text(img: np.ndarray, text: str, x: int, y: int, color,
              scale: int = 1) -> None:
    """Bitmap text, top-left anchored."""
    h, w = img.shape[:2]
    color = np.asarray(color, np.uint8)
    cx = x
    for ch in text:
        g = _glyph(ch)
        if scale > 1:
            g = np.kron(g, np.ones((scale, scale), bool))
        gh, gw = g.shape
        y0, x0 = max(y, 0), max(cx, 0)
        y1, x1 = min(y + gh, h), min(cx + gw, w)
        if y1 > y0 and x1 > x0:
            sub = g[y0 - y : y1 - y, x0 - cx : x1 - cx]
            img[y0:y1, x0:x1][sub] = color
        cx += gw + scale
    return


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal zlib PNG encoder (8-bit RGB or grayscale)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img.astype(np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(
        b"\x00" + img[r].tobytes() for r in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
