"""Host time of the port's PNG decoder (data/_image.py) by filter and size.

    python -m opensplat_tpu_torch.tools.png_bench [--sizes 512x512 1920x1080]

A PNG whose rows use only filters 0-2 (None, Sub, Up; the port's own
encoder writes None) decodes row by row; one with Average or Paeth rows,
as libpng's adaptive filtering writes them, decodes along anti-diagonals.
For each size the tool encodes one seeded image with filter None and with
libpng's adaptive heuristic (per row, the filter whose output has the
least sum of absolute signed bytes), plus cv2.imencode's file where cv2 is
installed, and prints one JSON line per file: the filters its rows use,
decode_png's median ms, the median ms of each unfilter path that can
decode it and, where cv2 is installed, cv2.imdecode's (what the JAX
package's loader pays). Host clock.
"""
from __future__ import annotations

import argparse
import json
import struct
import time
import zlib

import numpy as np

from ..data import _image


def sample_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A photo-like (H, W, 3) uint8: smooth gradients, soft blobs and
    sensor noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w, y / h, 0.5 + 0.5 * np.sin(x / 37 + y / 53)], -1)
    for cx, cy, r, c in zip(rng.uniform(0, w, 40), rng.uniform(0, h, 40),
                            rng.uniform(h / 50, h / 4, 40),
                            rng.uniform(0, 1, (40, 3))):
        img += 0.5 * np.exp(-((x - cx) ** 2 + (y - cy) ** 2)
                            / (2 * r * r))[..., None] * (c - 0.5)
    img = img * 255 + rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _filtered(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, W*bpp) uint8: each row under each filter type."""
    x = raw.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return (np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
            & 255).astype(np.uint8)


def encode_adaptive(rgb: np.ndarray) -> bytes:
    """PNG bytes with libpng's adaptive filter choice per row."""
    h, w, _ = rgb.shape
    cand = _filtered(rgb.reshape(h, 3 * w), 3)
    cost = np.abs(cand.astype(np.int8).astype(np.int32)).sum(-1)  # (5, H)
    ftype = cost.argmin(0).astype(np.uint8)
    rows = np.concatenate([ftype[:, None], cand[ftype, np.arange(h)]], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_image.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _unfilter_input(data: bytes):
    """What decode_png hands its unfilter paths (RGB, 8-bit only)."""
    idat, header = [], None
    for kind, body in _image._chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h = header[0], header[1]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 0], rows[:, 1:].reshape(h, w, 3).astype(np.int32)


def _median_ms(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts) * 1e3)


def bench(h: int, w: int, reps: int) -> list[dict]:
    img = sample_image(h, w)
    files = {"filter None (the port's encoder)": _image.encode_png(img),
             "adaptive (libpng's heuristic, numpy)": encode_adaptive(img)}
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        ok, buf = cv2.imencode(".png", img[..., ::-1])
        if ok:
            files["cv2.imencode (libpng)"] = buf.tobytes()
    out = []
    for label, data in files.items():
        if not np.array_equal(_image.decode_png(data), img):
            raise AssertionError(f"{label}: decode_png differs from the image")
        ftype, data3 = _unfilter_input(data)
        buf = np.zeros((h + 1, w + 1, 3), np.int32)
        paths = {"wavefront": lambda: _image._unfilter_wavefront(
            ftype, data3, buf)}
        if ftype.max() <= 2:
            paths["rows"] = lambda: _image._unfilter_rows(
                ftype, data3, buf[:, 1:])
        rec = {"size": f"{w}x{h}", "file": label, "bytes": len(data),
               "filters": {int(f): int(n) for f, n in
                           zip(*np.unique(ftype, return_counts=True))},
               "decode_png_ms": _median_ms(
                   lambda: _image.decode_png(data), reps)}
        for name, fn in paths.items():
            rec[f"unfilter_{name}_ms"] = _median_ms(fn, reps)
        if cv2 is not None:
            arr = np.frombuffer(data, np.uint8)
            rec["cv2_imdecode_ms"] = _median_ms(
                lambda: cv2.imdecode(arr, cv2.IMREAD_COLOR), reps)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", nargs="+", default=["512x512", "1920x1080"],
                    help="WxH")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    for size in args.sizes:
        w, h = map(int, size.split("x"))
        for rec in bench(h, w, args.reps):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
