"""Point-cloud I/O: PLY (binary little-endian + ascii), COLMAP points3D.bin
and LAS. The port's copy of opensplat_tpu/data/point_io.py (same bytes
written, same arrays read); points3D.bin goes through the port's own
native parser (native/loader.py) and through numpy where g++ is missing.

Behavioral spec from the reference's point_io.cpp:
  - fastPlyReadPointSet ... point_io.cpp:110-262 (x/y/z + optional normals,
    contiguous-but-possibly-permuted red/green/blue, optional views)
  - colmapReadPointSet .... point_io.cpp:361-394 (id, xyz f64, rgb u8,
    error f64, variable-length track skipped)
  - fastPlySavePointSet ... point_io.cpp:461-501
  - dispatch by extension . point_io.cpp:100-108 (LAS/LAZ needs PDAL in the
    reference; here it's gated the same way behind an optional laspy import)

The reader is re-designed rather than transliterated: the PLY header is
parsed into a numpy structured dtype so extraction of the wanted columns is
a single vectorized view, and points3D.bin is parsed with a single
offset-scan loop followed by one fancy-indexed gather (no per-point Python
field reads).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import warnings
from typing import Dict, List, Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class PointSet:
    points: np.ndarray  # (N, 3) float32
    colors: Optional[np.ndarray] = None  # (N, 3) uint8
    normals: Optional[np.ndarray] = None  # (N, 3) float32
    views: Optional[np.ndarray] = None  # (N,) uint8

    def count(self) -> int:
        return int(self.points.shape[0])

    def colors_or_gray(self) -> np.ndarray:
        if self.colors is not None:
            return self.colors
        return np.full((self.count(), 3), 128, np.uint8)


def read_point_set(filename: str) -> PointSet:
    """Dispatch by extension (point_io.cpp:100-108)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".ply":
        return read_ply_point_set(filename)
    if ext == ".bin":
        return read_colmap_points3d(filename)
    if ext in (".las", ".laz"):
        return _read_las_point_set(filename)
    raise RuntimeError(f"Unsupported point cloud file extension: {ext}")


def _parse_ply_header(f) -> Dict:
    """Parse the full PLY header -> {format, count, properties:[(name,dtype)]}."""
    line = f.readline().decode("ascii", "replace").strip()
    if line != "ply":
        raise RuntimeError("Invalid PLY file (header does not start with ply)")
    fmt = None
    count = None
    props: List = []
    in_vertex = False
    while True:
        raw = f.readline()
        if not raw:
            raise RuntimeError("Invalid PLY file (truncated header)")
        line = raw.decode("ascii", "replace").strip()
        if line.startswith("comment") or line.startswith("obj_info") or not line:
            continue
        if line.startswith("format"):
            fmt = line.split()[1]
            continue
        if line.startswith("element"):
            toks = line.split()
            in_vertex = toks[1] == "vertex"
            if in_vertex:
                count = int(toks[2])
            continue
        if line.startswith("property"):
            if not in_vertex:
                continue
            toks = line.split()
            if toks[1] == "list":
                raise RuntimeError("PLY list properties on vertices are unsupported")
            props.append((toks[-1], toks[1]))
            continue
        if line == "end_header":
            break
    if fmt is None or count is None:
        raise RuntimeError("Invalid PLY file (missing format/element vertex)")
    return {"format": fmt, "count": count, "properties": props}


def read_ply_point_set(filename: str) -> PointSet:
    """PLY reader covering the reference's feature set (point_io.cpp:110-262):
    float x/y/z; optional float normals (nx|normal_x|normalx); optional uint8
    red/green/blue (any contiguous order); optional uint8 views. Unlike the
    reference it tolerates extra properties (they are simply ignored)."""
    with open(filename, "rb") as f:
        hdr = _parse_ply_header(f)
        names = [n for n, _ in hdr["properties"]]
        for req in ("x", "y", "z"):
            if req not in names:
                raise RuntimeError(f"Invalid PLY file (missing property {req})")

        count = hdr["count"]
        normal_names = None
        for cand in (("nx", "ny", "nz"),
                     ("normal_x", "normal_y", "normal_z"),
                     ("normalx", "normaly", "normalz")):
            if all(c in names for c in cand):
                normal_names = cand
                break
        has_colors = all(c in names for c in ("red", "green", "blue"))
        has_views = "views" in names

        if hdr["format"] == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=count, ndmin=2)
            if data.shape[1] != len(names):
                raise RuntimeError("Invalid PLY file (column count mismatch)")
            cols = {n: data[:, i] for i, n in enumerate(names)}
        else:
            endian = "<" if hdr["format"] == "binary_little_endian" else ">"
            dt = np.dtype(
                [(n, endian + _PLY_DTYPES[t]) for n, t in hdr["properties"]]
            )
            rec = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
            cols = {n: rec[n] for n in names}

        points = np.stack(
            [cols["x"], cols["y"], cols["z"]], axis=1
        ).astype(np.float32)
        normals = None
        if normal_names is not None:
            normals = np.stack(
                [cols[c] for c in normal_names], axis=1
            ).astype(np.float32)
        colors = None
        if has_colors:
            colors = np.stack(
                [cols["red"], cols["green"], cols["blue"]], axis=1
            ).astype(np.uint8)
        views = cols["views"].astype(np.uint8) if has_views else None
        return PointSet(points=points, colors=colors, normals=normals, views=views)


def read_colmap_points3d(filename: str) -> PointSet:
    """COLMAP points3D.bin (point_io.cpp:361-394).

    Record: u64 id, 3x f64 xyz, 3x u8 rgb, f64 error, u64 track_len,
    track_len x (u32 image_id, u32 point2D_idx) = 8 bytes each.

    Uses the native C++ single-pass parser when available
    (native/point_io.cpp); the numpy fallback finds record offsets with
    one cheap scan (only track_len is read per record) and then gathers
    the payload vectorized.
    """
    with open(filename, "rb") as f:
        buf = f.read()
    native = _native_colmap_points3d(buf)
    if native is not None:
        return native
    n = struct.unpack_from("<Q", buf, 0)[0]
    head = 8 + 24 + 3 + 8  # id + xyz + rgb + error
    offsets = np.empty(n, np.int64)
    pos = 8
    unpack_q = struct.unpack_from
    for i in range(n):
        offsets[i] = pos
        track_len = unpack_q("<Q", buf, pos + head)[0]
        pos += head + 8 + 8 * track_len
    arr = np.frombuffer(buf, np.uint8)
    # gather the fixed-size head of every record into an (n, head) table
    table = arr[offsets[:, None] + np.arange(head, dtype=np.int64)]
    xyz = table[:, 8:32].copy().view("<f8").reshape(n, 3).astype(np.float32)
    rgb = table[:, 32:35].copy()
    return PointSet(points=xyz, colors=rgb)


def _native_colmap_points3d(buf: bytes):
    """points3D.bin via the C++ single-pass parser; None -> use numpy."""
    import ctypes

    from ..native.loader import get_lib

    lib = get_lib()
    if lib is None:
        return None
    n = lib.colmap_points3d_count(buf, len(buf))
    if n < 0:
        raise RuntimeError("Malformed points3D.bin (truncated header)")
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.uint8)
    parsed = lib.colmap_points3d_parse(
        buf,
        len(buf),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
    )
    if parsed != n:
        raise RuntimeError(
            f"Malformed points3D.bin (parsed {parsed} of {n} points)"
        )
    return PointSet(points=xyz, colors=rgb)


def _read_las_numpy(filename: str) -> PointSet:
    """Uncompressed-LAS reader in pure numpy (no laspy needed) — the
    native counterpart of the reference's PDAL path
    (point_io.cpp:264-359). Handles LAS 1.0-1.4, point record formats
    0-10 (XYZ always at record offset 0; RGB at the per-format offset)."""
    with open(filename, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise RuntimeError(f"{filename}: not a LAS file (bad signature)")
        point_offset = int(np.frombuffer(header, "<u4", 1, 96)[0])
        fmt = header[104]
        if fmt & 0x80:
            raise RuntimeError(
                f"{filename}: LAZ-compressed points require the optional "
                "laspy[lazrs] package"
            )
        rec_len = int(np.frombuffer(header, "<u2", 1, 105)[0])
        n = int(np.frombuffer(header, "<u4", 1, 107)[0])
        if n == 0 and len(header) >= 255:  # LAS 1.4 extended count
            n = int(np.frombuffer(header, "<u8", 1, 247)[0])
        scale = np.frombuffer(header, "<f8", 3, 131)
        offset = np.frombuffer(header, "<f8", 3, 155)
        f.seek(point_offset)
        raw = np.frombuffer(f.read(n * rec_len), np.uint8).reshape(n, rec_len)

    def field(off, dtype, count=1):
        width = np.dtype(dtype).itemsize * count
        return (
            raw[:, off:off + width].copy().view(dtype).reshape(n, count)
        )

    xyz_i = field(0, "<i4", 3).astype(np.float64)
    points = (xyz_i * scale[None, :] + offset[None, :]).astype(np.float32)

    # RGB record offsets per point data record format (LAS 1.4 spec)
    rgb_off = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}.get(int(fmt))
    colors = None
    if rgb_off is not None and rec_len >= rgb_off + 6:
        rgb16 = field(rgb_off, "<u2", 3).astype(np.uint32)
        if rgb16.max(initial=0) > 255:  # 16-bit color convention
            rgb16 = rgb16 * 255 // 65535
        colors = rgb16.astype(np.uint8)
    return PointSet(points=points, colors=colors)


def _read_las_point_set(filename: str) -> PointSet:
    """LAS/LAZ loader (reference gates this behind PDAL,
    point_io.cpp:264-359): uncompressed .las reads natively via numpy;
    .laz decompression uses laspy when installed."""
    try:
        import laspy  # type: ignore
    except ImportError as e:
        if filename.lower().endswith(".laz"):
            raise RuntimeError(
                "LAZ decompression requires the optional laspy[lazrs] "
                "package (mirroring the reference's optional PDAL support); "
                "uncompressed .las needs no extra packages"
            ) from e
        return _read_las_numpy(filename)
    las = laspy.read(filename)
    points = np.stack([las.x, las.y, las.z], axis=1).astype(np.float32)
    colors = None
    if "red" in las.point_format.dimension_names:
        r, g, b = np.asarray(las.red), np.asarray(las.green), np.asarray(las.blue)
        if max(r.max(initial=0), g.max(initial=0), b.max(initial=0)) > 255:
            r, g, b = (
                (r / 65535.0 * 255.0).astype(np.uint8),
                (g / 65535.0 * 255.0).astype(np.uint8),
                (b / 65535.0 * 255.0).astype(np.uint8),
            )
        colors = np.stack([r, g, b], axis=1).astype(np.uint8)
    return PointSet(points=points, colors=colors)


def _save_las(pset: PointSet, filename: str):
    """Uncompressed LAS 1.2 writer (point record format 2: XYZ + RGB) in
    pure numpy — the native counterpart of the reference's optional PDAL
    writer (point_io.cpp:411-459, savePointSet LAS branch). Colors use
    the 16-bit convention (v * 257) so spec-conformant readers — and
    _read_las_numpy — recover the exact 8-bit values."""
    n = pset.count()
    pts = pset.points.astype(np.float64)
    lo = pts.min(axis=0) if n else np.zeros(3)
    hi = pts.max(axis=0) if n else np.zeros(3)
    # per-axis scale: span the extent over the int32 range (never below
    # 1e-9 so degenerate axes still encode)
    scale = np.maximum((hi - lo) / (2**31 - 2), 1e-9)
    header = bytearray(227)
    header[0:4] = b"LASF"
    header[24] = 1  # version major
    header[25] = 2  # version minor
    header[26:26 + 13] = b"opensplat_tpu"
    header[58:58 + 13] = b"opensplat_tpu"
    header[94:96] = np.uint16(227).tobytes()  # header size
    header[96:100] = np.uint32(227).tobytes()  # offset to point data
    header[104] = 2  # point data record format
    header[105:107] = np.uint16(26).tobytes()  # record length
    header[107:111] = np.uint32(n).tobytes()
    header[111:115] = np.uint32(n).tobytes()  # points by return[0]
    header[131:155] = scale.astype("<f8").tobytes()
    header[155:179] = lo.astype("<f8").tobytes()
    header[179:227] = np.stack(
        [hi, lo], axis=1
    ).reshape(-1).astype("<f8").tobytes()  # max/min interleaved per axis

    rec = np.zeros(
        n,
        dtype=np.dtype(
            [("xyz", "<i4", 3), ("intensity", "<u2"), ("flags", "u1"),
             ("cls", "u1"), ("angle", "i1"), ("user", "u1"),
             ("src", "<u2"), ("rgb", "<u2", 3)]
        ),
    )
    rec["xyz"] = np.round((pts - lo[None, :]) / scale[None, :]).astype(np.int32)
    if pset.colors is not None:
        rec["rgb"] = pset.colors.astype(np.uint16) * 257
    with open(filename, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def save_point_set(pset: PointSet, filename: str):
    """Point-cloud writer dispatched by extension, like the reference's
    savePointSet (point_io.cpp:411-414): .ply gets the fast binary PLY
    path, .las the native LAS writer, .laz a laspy write when the
    optional package is installed; anything else errors (the reference
    routes unknown extensions to PDAL and errors without it)."""
    lower = filename.lower()
    if lower.endswith((".las", ".laz")):
        if pset.normals is not None or pset.views is not None:
            warnings.warn(
                "LAS point record format 2 cannot carry normals/views; "
                "they are dropped on write (use .ply to keep them)",
                stacklevel=2,
            )
        if lower.endswith(".laz"):
            return _save_laz(pset, filename)
        return _save_las(pset, filename)
    if lower.endswith(".ply"):
        return _save_ply(pset, filename)
    raise RuntimeError(
        f"Unsupported file extension: {filename} (supported: .ply, .las, "
        ".laz — mirroring the reference's savePointSet dispatch, "
        "point_io.cpp:411-414)"
    )


def _save_laz(pset: PointSet, filename: str):
    """LAZ writer via optional laspy[lazrs] (the read path's optional-
    dependency pattern; the reference needs optional PDAL for LAZ too,
    point_io.cpp:411-459)."""
    try:
        import laspy  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "LAZ compression on write requires the optional laspy[lazrs] "
            "package (the reference needs optional PDAL for it too); "
            "write .las instead"
        ) from e
    header = laspy.LasHeader(version="1.2", point_format=2)
    pts = pset.points.astype(np.float64)
    lo = pts.min(axis=0) if len(pts) else np.zeros(3)
    hi = pts.max(axis=0) if len(pts) else np.zeros(3)
    header.offsets = lo
    header.scales = np.maximum((hi - lo) / (2**31 - 2), 1e-9)
    las = laspy.LasData(header)
    las.x, las.y, las.z = pts[:, 0], pts[:, 1], pts[:, 2]
    if pset.colors is not None:
        rgb16 = pset.colors.astype(np.uint16) * 257
        las.red, las.green, las.blue = rgb16[:, 0], rgb16[:, 1], rgb16[:, 2]
    try:
        las.write(filename)
    except laspy.LaspyException as e:
        # laspy installed but no LAZ backend (lazrs/laszip) — surface the
        # same actionable message as the missing-package path
        raise RuntimeError(
            "LAZ compression on write requires a laspy LAZ backend "
            "(pip install 'laspy[lazrs]'); write .las instead"
        ) from e


def _save_ply(pset: PointSet, filename: str):
    """Binary-LE PLY writer, same layout as the reference
    (point_io.cpp:461-501)."""
    n = pset.count()
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header = [
        b"ply",
        b"format binary_little_endian 1.0",
        b"comment Generated by opensplat_tpu",
        b"element vertex " + str(n).encode(),
        b"property float x",
        b"property float y",
        b"property float z",
    ]
    if pset.normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header += [b"property float nx", b"property float ny", b"property float nz"]
    if pset.colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header += [
            b"property uchar red",
            b"property uchar green",
            b"property uchar blue",
        ]
    if pset.views is not None:
        fields += [("views", "u1")]
        header += [b"property uchar views"]
    header.append(b"end_header")

    rec = np.zeros(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = (
        pset.points[:, 0],
        pset.points[:, 1],
        pset.points[:, 2],
    )
    if pset.normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = (
            pset.normals[:, 0],
            pset.normals[:, 1],
            pset.normals[:, 2],
        )
    if pset.colors is not None:
        rec["red"], rec["green"], rec["blue"] = (
            pset.colors[:, 0],
            pset.colors[:, 1],
            pset.colors[:, 2],
        )
    if pset.views is not None:
        rec["views"] = pset.views
    with open(filename, "wb") as f:
        f.write(b"\n".join(header) + b"\n")
        f.write(rec.tobytes())
