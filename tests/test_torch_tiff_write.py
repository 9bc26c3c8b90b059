"""The port's GeoTIFF writer against the JAX package's, at several strips.

The port encodes a raster's strips on a pool of threads and takes the
floating-point predictor's byte differences in uint8; the JAX package
encodes them one after another with the differences widened to int16. Both
must write the same file, byte for byte:

* rasters of three or more strips with a short last one (float32, float64,
  three-band float32) holding NaN, ±inf, -9999 and denormals, under none,
  deflate and lzw, the predictor on and off, classic and BigTIFF;
* the pure-Python LZW encoder at two strips, against the JAX package's
  native one;
* the uint8 predictor against the int16 formula on random bytes;
* one thread and many, set through the CPUs the process may use, with no
  pool thread left running after a write.
"""

import os
import threading

import numpy as np
import pytest

from resdepth_tpu.geo import tiff as j_tiff
from resdepth_tpu_torch.geo import _native as t_native
from resdepth_tpu_torch.geo import tiff as t_tiff

GEOTRANSFORM = (465000.0, 0.25, 0.0, 5247000.0, 0.0, -0.25)

# name: (dtype, shape); strips of 511, 255 and 170 rows, the last one short
RASTERS = {
    "float32": (np.float32, (1100, 513)),
    "float64": (np.float64, (600, 513)),
    "float32x3": (np.float32, (400, 513, 3)),
}


def _raster(dtype, shape, seed=0):
    """A DSM-like raster with a nodata block and scattered special values."""
    rng = np.random.default_rng(seed)
    y, x = np.indices(shape[:2])
    relief = 20.0 * np.sin(x / 97.0) * np.cos(y / 131.0)
    if len(shape) == 3:
        relief = relief[:, :, None]
    data = (400.0 + relief + rng.normal(0.0, 0.3, shape)).astype(dtype)
    data[7:19, 30:61] = -9999.0
    tiny = np.finfo(dtype).smallest_subnormal
    specials = np.array([np.nan, np.inf, -np.inf, -9999.0, tiny, -tiny, 3 * tiny],
                        dtype)
    flat = data.reshape(-1)
    where = rng.choice(flat.size, size=flat.size // 50, replace=False)
    flat[where] = np.resize(specials, where.size)
    return data


def _write_both(tmp_path, data, **kwargs):
    """Write ``data`` with each package; return the two files' bytes."""
    files = {}
    for name, tiff in (("jax", j_tiff), ("port", t_tiff)):
        path = tmp_path / f"{name}.tif"
        tiff.write(str(path), data, geotransform=GEOTRANSFORM, nodata=-9999.0,
                   **kwargs)
        files[name] = path.read_bytes()
    return files["jax"], files["port"]


@pytest.mark.parametrize("bigtiff", [False, True], ids=["classic", "bigtiff"])
@pytest.mark.parametrize("predictor", [True, False], ids=["predictor", "raw"])
@pytest.mark.parametrize("compress", ["none", "deflate", "lzw"])
@pytest.mark.parametrize("raster", list(RASTERS))
def test_multistrip_bytes_match_jax(tmp_path, raster, compress, predictor, bigtiff):
    dtype, shape = RASTERS[raster]
    data = _raster(dtype, shape)
    want, got = _write_both(tmp_path, data, compress=compress,
                            predictor=predictor, bigtiff=bigtiff)
    assert got == want
    back, info = t_tiff.read(str(tmp_path / "port.tif"))
    assert len(info.tags[t_tiff.STRIP_OFFSETS]) >= 3
    assert back.tobytes() == data.tobytes()


def test_python_lzw_at_two_strips_matches_native(tmp_path, monkeypatch):
    """The pure-Python LZW encoder, run on the pool, writes the bytes of the
    JAX package's native encoder."""
    data = _raster(np.float32, (515, 513), seed=1)  # strips of 511 and 4 rows

    def refuse(*args, **kwargs):
        raise RuntimeError("native codec switched off for this test")

    j_tiff.write(str(tmp_path / "jax.tif"), data, geotransform=GEOTRANSFORM,
                 nodata=-9999.0, compress="lzw")
    monkeypatch.setattr(t_native, "lzw_encode", refuse)
    t_tiff.write(str(tmp_path / "port.tif"), data, geotransform=GEOTRANSFORM,
                 nodata=-9999.0, compress="lzw")
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()


def _int16_float_predictor(block):
    """libtiff's fpDiff as the writer took it before: the byte differences
    widened to int16 and taken mod 256."""
    rows = block.shape[0]
    spp = block.shape[2] if block.ndim == 3 else 1
    raw = np.frombuffer(block.tobytes(), np.uint8).reshape(
        rows, -1, block.dtype.itemsize)
    planes = raw[:, :, ::-1].transpose(0, 2, 1).reshape(rows, -1)
    diff = planes.astype(np.int16)
    diff[:, spp:] -= planes[:, :-spp].astype(np.int16)
    return (diff % 256).astype(np.uint8).tobytes()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spp", [1, 3])
def test_uint8_predictor_matches_int16_formula(spp, dtype, seed):
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(1, 40), rng.integers(1, 70)
    shape = (rows, cols) if spp == 1 else (rows, cols, spp)
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    block = rng.integers(0, 256, nbytes, dtype=np.uint8).view(dtype).reshape(shape)
    assert t_tiff._apply_float_predictor(block) == _int16_float_predictor(block)


@pytest.mark.parametrize("cpus", [1, 2, 64])
@pytest.mark.parametrize("compress", ["none", "deflate", "lzw"])
def test_thread_count_keeps_bytes(tmp_path, monkeypatch, compress, cpus):
    """Whatever the CPUs the process may use, the file is the same; one CPU
    encodes on the calling thread, more on at most one pool thread a strip,
    and no pool thread outlives the write."""
    data = _raster(np.float32, RASTERS["float32x3"][1], seed=2)  # 3 strips
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)),
                        raising=False)
    threads = []
    encode = t_tiff._encode_strip

    def recorded(*args, **kwargs):
        threads.append(threading.get_ident())
        return encode(*args, **kwargs)

    monkeypatch.setattr(t_tiff, "_encode_strip", recorded)
    running = threading.active_count()
    want, got = _write_both(tmp_path, data, compress=compress)
    assert got == want
    assert len(threads) == 3
    if cpus == 1:
        assert set(threads) == {threading.get_ident()}
    else:
        assert threading.get_ident() not in threads
        assert len(set(threads)) <= min(cpus, 3)
    assert threading.active_count() == running


@pytest.mark.parametrize("cpu_count,want", [(5, 5), (None, 1)])
def test_usable_cpus_without_affinity(monkeypatch, cpu_count, want):
    monkeypatch.delattr(os, "sched_getaffinity", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: cpu_count)
    assert t_tiff._usable_cpus() == want
