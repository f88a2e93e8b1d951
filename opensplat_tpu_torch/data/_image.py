"""Image I/O and area resizing without OpenCV.

The JAX package reads, resizes and undistorts images with cv2
(opensplat_tpu/data/dataset.py:56-112). The port reads PNG with numpy and
zlib, and resizes with OpenCV's INTER_AREA weights
(computeResizeAreaTab), so a project of PNG images without distortion
loads with numpy, scipy and the standard library alone. JPEG and other
formats, PNG variants `decode_png` does not take (interlaced, bit depths
other than 8) and undistortion still need cv2, imported only there; a
missing cv2 raises an error that names the file.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import scipy.sparse

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


class UnsupportedPNG(ValueError):
    """A PNG variant decode_png does not decode (cv2 reads it)."""


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _unfilter_rows(ftype, data, out):
    """Filters 0-2 (None, Sub, Up) row by row, each row vectorised."""
    for r, f in enumerate(ftype):
        x = data[r]
        if f == 1:
            x = np.cumsum(x, axis=0)
        elif f == 2:
            x = x + out[r]
        out[r + 1] = x & 255


def _unfilter_wavefront(ftype, data, out):
    """All five filters. A byte depends on its left, upper and upper-left
    neighbours, so the pixels of one anti-diagonal are independent: one
    vectorised step per anti-diagonal."""
    h, w, _ = data.shape
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a = out[r + 1, x]  # left (padded column 0 is zero)
        b = out[r, x + 1]  # up (padded row 0 is zero)
        c = out[r, x]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (data[r, x] + pred) & 255


def decode_png(data: bytes) -> np.ndarray:
    """8-bit, non-interlaced PNG (gray, gray+alpha, RGB, RGBA or palette)
    -> (H, W, 3) uint8 RGB, as cv2.imread(IMREAD_COLOR) reads it: gray
    replicated, alpha dropped, palette looked up. Raises UnsupportedPNG
    for other bit depths and interlaced files."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"invalid PNG colour type {ctype}")
    if depth != 8 or interlace:
        raise UnsupportedPNG(f"bit depth {depth}, interlace {interlace}")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * bpp):
        raise ValueError("truncated PNG image data")
    rows = raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError("invalid PNG filter type")
    data3 = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # zero row and column
    if ftype.max(initial=0) <= 2:
        _unfilter_rows(ftype, data3, out[:, 1:])
    else:
        _unfilter_wavefront(ftype, data3, out)
    px = out[1:, 1:].astype(np.uint8)
    if ctype == 3:
        if palette is None or px.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (filter None, zlib level 6)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _import_cv2(path: str, why: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: {why} needs OpenCV (cv2), which is not installed; "
            "PNG images without distortion load without it") from e
    return cv2


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB. PNG through decode_png; other formats and
    PNG variants it does not take through cv2.imread."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        try:
            return decode_png(data)
        except UnsupportedPNG:
            pass
    cv2 = _import_cv2(path, "reading this image")
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _area_weights(ssize: int, dsize: int, scale: float):
    """(dsize, ssize) sparse INTER_AREA weights: OpenCV's
    computeResizeAreaTab, each weight rounded to float32 as there."""
    rows, cols, vals = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            rows.append(dx), cols.append(sx1 - 1)
            vals.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            rows.append(dx), cols.append(sx), vals.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            rows.append(dx), cols.append(sx2)
            vals.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    vals = np.asarray(vals, np.float32).astype(np.float64)
    return scipy.sparse.csr_matrix((vals, (rows, cols)),
                                   shape=(dsize, ssize))


def resize_area(img: np.ndarray, dsize=None, factor: float = None):
    """cv2.resize(img, dsize, interpolation=INTER_AREA) for a downscale,
    or with dsize None cv2.resize(img, (0, 0), fx=factor, fy=factor,
    INTER_AREA). img is (H, W, C) uint8 or float32. The sums run in
    float64 where cv2 uses float32, and uint8 rounds half to even as
    cvRound does; cv2's 2x2 fast path rounds half up, so uint8 results
    are within 1 of cv2's and float32 ones within 1e-6."""
    h, w, c = img.shape
    if dsize is None:
        dw, dh = round(w * factor), round(h * factor)
        scale_x = scale_y = 1.0 / factor
    else:
        dw, dh = dsize
        scale_x, scale_y = 1.0 / (dw / w), 1.0 / (dh / h)
    if scale_x < 1.0 or scale_y < 1.0:
        raise ValueError("resize_area only downscales")
    wy = _area_weights(h, dh, scale_y)
    wx = _area_weights(w, dw, scale_x)
    x = np.asarray(img, np.float64)
    tmp = (wy @ x.reshape(h, w * c)).reshape(dh, w, c)
    out = (wx @ tmp.transpose(1, 0, 2).reshape(w, dh * c)).reshape(dw, dh, c)
    out = out.transpose(1, 0, 2)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def undistort(img: np.ndarray, K: np.ndarray, dist: np.ndarray, path: str):
    """getOptimalNewCameraMatrix(alpha 0) + undistort + ROI crop
    (input_data.cpp:71-96) through cv2; returns (image, new K)."""
    cv2 = _import_cv2(path, "undistortion")
    new_k, roi = cv2.getOptimalNewCameraMatrix(
        K, dist, (img.shape[1], img.shape[0]), 0)
    img = cv2.undistort(img, K, dist, None, new_k)
    x, y, w, h = roi
    return img[y:y + h, x:x + w], new_k
