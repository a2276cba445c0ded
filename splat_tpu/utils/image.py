"""Image utilities: dependency-free PNG write/read and PSNR.

Replaces the reference's minifb window blit (src/main.rs:79) as the output
path — on a headless accelerator host the deliverable is a u8 image back
from device memory, written to disk.  PNG codec is pure Python (zlib +
struct), enough for RGB8 frames.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, *, level: int = 6) -> bytes:
    """Encode an (H, W, 3) RGB or (H, W, 4) RGBA uint8 (or float in [0,1])
    array as PNG bytes (color type 2 / 6).

    level: zlib level 0-9.  Level 0 (stored blocks) encodes a 1080p frame
    in ~17 ms vs ~340 ms at level 3 (measured; splat frames are smooth but
    large) at ~3x the bytes — the right trade for a localhost interactive
    viewer, where encode latency is serving latency.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {c}")
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, *, level: int = 6) -> None:
    """Write an (H, W, 3) RGB or (H, W, 4) RGBA uint8 (or float in [0,1])
    array as a PNG (see :func:`encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(img, level=level))


def read_png(path: str) -> np.ndarray:
    """Read an RGB(A) 8-bit PNG written by :func:`write_png` (filter 0/paeth
    subset: supports filter types 0-4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = coltype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, coltype = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if bitdepth != 8 or coltype not in (2, 6):
        raise ValueError(f"unsupported PNG (depth={bitdepth}, color={coltype})")
    nch = 3 if coltype == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(h):
        ftype = raw[off]
        row = np.frombuffer(raw[off + 1:off + 1 + stride],
                            np.uint8).astype(np.int32)
        off += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 2:  # up
            cur = (row + prev) & 0xFF
        else:  # sub / average / paeth need sequential recon
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[i] = (row[i] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    # RGBA PNGs keep their alpha plane; RGB stays (H, W, 3)
    return out.reshape(h, w, nch)


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.dtype == np.uint8 or b.dtype == np.uint8:
        raise ValueError("convert to float before psnr")
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range * data_range / mse))


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def box_downsample(img, k: int):
    """Average k x k pixel blocks: (H*k, W*k, C) -> (H, W, C).

    Works on NumPy and JAX arrays alike (pure reshape + mean, traceable
    and differentiable).  The downsampling half of supersampled
    anti-aliasing (RenderConfig.supersample; the reference notebook's
    cell-3 supersampled target, SURVEY §2.1).
    """
    if k == 1:
        return img
    hk, wk, c = img.shape
    if hk % k or wk % k:
        raise ValueError(f"image {img.shape} not divisible by supersample "
                         f"factor {k}")
    return img.reshape(hk // k, k, wk // k, k, c).mean(axis=(1, 3))
