"""The least GeoTIFF the CLI cell needs, written and read here rather
than by the program: a little-endian classic TIFF of one band in strips,
the geotransform as ModelPixelScale (33550) and ModelTiepoint (33922), the
nodata value as GDAL's tag (42113). ``write`` stores uncompressed
float32 or uint8; ``read`` also takes deflate (8) and the floating-point
predictor (3), which the program's ``geo/raster.py::write_raster`` uses."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_TYPES = {2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 12: ("d", 8)}


def write(path: str, data: np.ndarray, geotransform, nodata) -> None:
    data = np.ascontiguousarray(data)
    rows, cols = data.shape
    float_ = data.dtype == np.float32
    if not float_ and data.dtype != np.uint8:
        raise ValueError(f"float32 or uint8 only, not {data.dtype}")
    x0, gsd, _, y0, _, neg_gsd = geotransform
    nodata_text = f"{nodata:g}".encode() + b"\0"
    entries = [(256, 4, [cols]), (257, 4, [rows]), (258, 3, [8 * data.itemsize]),
               (259, 3, [1]), (262, 3, [1]), (273, 4, [0]), (277, 3, [1]),
               (278, 4, [rows]), (279, 4, [data.nbytes]), (284, 3, [1]),
               (339, 3, [3 if float_ else 1]), (33550, 12, [gsd, -neg_gsd, 0.0]),
               (33922, 12, [0.0, 0.0, 0.0, x0, y0, 0.0]), (42113, 2, nodata_text)]
    ifd_size = 2 + 12 * len(entries) + 4
    extra, extra_at = b"", 8 + ifd_size
    fields = []
    for tag, ftype, values in entries:
        code, size = _TYPES[ftype]
        blob = (values if ftype == 2 else
                struct.pack(f"<{len(values)}{code}", *values))
        if len(blob) <= 4:
            fields.append((tag, ftype, len(blob) // size, blob.ljust(4, b"\0")))
        else:
            fields.append((tag, ftype, len(blob) // size,
                           struct.pack("<I", extra_at + len(extra))))
            extra += blob + b"\0" * (len(blob) % 2)
    pixels_at = extra_at + len(extra)
    fields = [(t, f, n, struct.pack("<I", pixels_at)) if t == 273 else (t, f, n, v)
              for t, f, n, v in fields]
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", len(fields)))
        for tag, ftype, count, value in fields:
            f.write(struct.pack("<HHI", tag, ftype, count) + value)
        f.write(struct.pack("<I", 0) + extra)
        f.write(data.astype(data.dtype.newbyteorder("<")).tobytes())


def read(path: str) -> np.ndarray:
    """The first band of a one-band strip TIFF, little- or big-endian."""
    with open(path, "rb") as f:
        raw = f.read()
    bo = "<" if raw[:2] == b"II" else ">"
    (offset,) = struct.unpack(bo + "I", raw[4:8])
    (n,) = struct.unpack(bo + "H", raw[offset:offset + 2])
    tags = {}
    for i in range(n):
        tag, ftype, count, value = struct.unpack(
            bo + "HHI4s", raw[offset + 2 + 12 * i:offset + 14 + 12 * i])
        if ftype not in _TYPES or ftype == 2:
            continue
        code, size = _TYPES[ftype]
        if count * size > 4:
            (at,) = struct.unpack(bo + "I", value)
            value = raw[at:at + count * size]
        tags[tag] = struct.unpack(f"{bo}{count}{code}", value[:count * size])
    cols, rows = tags[256][0], tags[257][0]
    bits, fmt = tags[258][0], tags.get(339, (1,))[0]
    dtype = np.dtype({(32, 3): "f4", (8, 1): "u1"}[(bits, fmt)])
    compression, predictor = tags.get(259, (1,))[0], tags.get(317, (1,))[0]
    per_strip = tags.get(278, (rows,))[0]
    out, y = np.empty((rows, cols), dtype), 0
    for at, count in zip(tags[273], tags[279]):
        chunk = raw[at:at + count]
        if compression == 8:
            chunk = zlib.decompress(chunk)
        elif compression != 1:
            raise ValueError(f"compression {compression} not read here")
        h = min(per_strip, rows - y)
        if predictor == 3:
            # The byte planes of each row, differenced: sum them back, then
            # put each sample's bytes together, most significant first.
            planes = np.frombuffer(chunk, np.uint8).reshape(h, dtype.itemsize * cols)
            planes = np.cumsum(planes, axis=1, dtype=np.uint8)
            block = planes.reshape(h, dtype.itemsize, cols).transpose(0, 2, 1)
            block = np.ascontiguousarray(block).view(dtype.newbyteorder(">"))[..., 0]
        else:
            block = np.frombuffer(chunk, dtype.newbyteorder(bo)).reshape(h, cols)
        out[y:y + h] = block
        y += h
    return out
