"""Port stitch (resdepth_tpu_torch.ops.stitch) against the JAX stitches.

The plain torch stitch is the CPU reference the CUDA kernels K1 and K2 are
held against on the card (chip_smoke.py); here it is held against the JAX
package's XLA scatter-add and both Pallas kernels in interpret mode, on the
same inputs. Tolerance: 2 f32 ulps at scene heights of about 400 m
(6.1e-5 m): per pixel up to four tiles meet, and XLA may fuse the
denormalisation into one FMA where torch rounds twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from resdepth_tpu.geo.grid import create_regular_grid, positions_as_array
from resdepth_tpu.ops import blend
from resdepth_tpu.ops.pallas_stitch import (crop_scene, pad_scene,
                                            stitch_tiles_pallas,
                                            stitch_tiles_pallas_fused,
                                            stitch_tiles_xla)
from resdepth_tpu_torch.ops import stitch

SIGMA = 5.0


def _ulps(reference, n=2):
    return n * float(np.spacing(np.float32(np.abs(reference).max())))


def _inputs(rows=64, cols=80, t=16, b=7, seed=0):
    rng = np.random.default_rng(seed)
    scene = np.zeros((rows, cols), np.float32)
    tiles = rng.normal(size=(b, t, t)).astype(np.float32)
    positions = np.stack([rng.integers(0, rows - t + 1, b),
                          rng.integers(0, cols - t + 1, b)], 1).astype(np.int32)
    positions[1] = positions[0]            # overlapping tiles accumulate
    positions[2] = positions[0] + 3
    wy = rng.random((b, t)).astype(np.float32)
    wx = rng.random((b, t)).astype(np.float32)
    means = rng.normal(400.0, 2.0, b).astype(np.float32)
    return scene, tiles, positions, wy, wx, means


def _plain(scene, tiles, positions, wy, wx, means, sigma=SIGMA):
    out = torch.from_numpy(scene.copy())
    result = stitch.stitch_tiles_plain(
        out, torch.from_numpy(tiles), torch.from_numpy(positions),
        torch.from_numpy(wy), torch.from_numpy(wx), torch.from_numpy(means), sigma)
    assert result is out                   # in place
    return out.numpy()


def _jax(kind, scene, tiles, positions, wy, wx, means, sigma=SIGMA):
    args = [jnp.asarray(a) for a in (tiles, positions, wy, wx, means)]
    if kind == "xla":
        out = stitch_tiles_xla(jnp.asarray(scene), *args, sigma)
    else:
        kernel = stitch_tiles_pallas if kind == "pallas" else stitch_tiles_pallas_fused
        out = crop_scene(kernel(pad_scene(jnp.asarray(scene)), *args, sigma,
                                interpret=True))
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["xla", "pallas", "pallas_fused"])
def test_plain_matches_jax(kind, seed):
    inputs = _inputs(seed=seed)
    want = _jax(kind, *inputs)
    got = _plain(*inputs)
    assert np.abs(want).max() > 300.0      # scene heights, where ulps are coarse
    np.testing.assert_allclose(got, want, rtol=0, atol=_ulps(want))


@pytest.mark.parametrize("threads", [1, 4])
def test_plain_sums_in_batch_order(threads):
    """Each pixel sums as scene + tile_0 + tile_1 + ... whatever the CPU
    thread count: bitwise equal to an explicit loop over the tiles."""
    scene, tiles, positions, wy, wx, means = _inputs(seed=6, b=12)
    tiles_t, wy_t, wx_t = (torch.from_numpy(a) for a in (tiles, wy, wx))
    pred = tiles_t * torch.tensor(SIGMA) + torch.from_numpy(means)[:, None, None]
    weighted = pred * (wy_t[:, :, None] * wx_t[:, None, :])
    want = torch.from_numpy(scene.copy())
    t = tiles.shape[1]
    for (y, x), w in zip(positions.tolist(), weighted):
        want[y:y + t, x:x + t] += w
    previous = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = _plain(scene, tiles, positions, wy, wx, means)
    finally:
        torch.set_num_threads(previous)
    np.testing.assert_array_equal(got, want.numpy())


def test_plain_rejects_tiles_outside_the_canvas():
    scene, tiles, positions, wy, wx, means = _inputs(seed=7)
    positions[3, 1] = scene.shape[1] - tiles.shape[1] + 1
    with pytest.raises(ValueError, match="outside"):
        _plain(scene, tiles, positions, wy, wx, means)


def test_plain_accumulates_onto_existing_scene():
    scene, tiles, positions, wy, wx, means = _inputs(seed=2)
    scene = np.random.default_rng(3).normal(400.0, 1.0, scene.shape).astype(np.float32)
    want = _jax("xla", scene, tiles, positions, wy, wx, means)
    np.testing.assert_allclose(_plain(scene, tiles, positions, wy, wx, means),
                               want, rtol=0, atol=_ulps(want))


def test_zero_weight_padding_adds_nothing():
    scene, tiles, positions, wy, wx, means = _inputs(seed=4)
    want = _plain(scene, tiles, positions, wy, wx, means)
    pad = 5
    padded = (scene,
              np.concatenate([tiles, np.full((pad,) + tiles.shape[1:], 7.0, np.float32)]),
              np.concatenate([positions, np.zeros((pad, 2), np.int32)]),
              np.concatenate([wy, np.zeros((pad, wy.shape[1]), np.float32)]),
              np.concatenate([wx, np.zeros((pad, wx.shape[1]), np.float32)]),
              np.concatenate([means, np.full(pad, 400.0, np.float32)]))
    np.testing.assert_array_equal(_plain(*padded), want)


@pytest.mark.parametrize("stride_frac", [(1, 2), (3, 4)], ids=["T/2", "3T/4"])
def test_partition_of_unity(stride_frac):
    """A constant height stitched over a create_regular_grid tiling comes
    back unchanged over the region and 0 outside it."""
    t = 16
    stride = t * stride_frac[0] // stride_frac[1]
    rows, cols = 70, 90
    area = {"x_extent": [(5, 84)], "y_extent": [(3, 60)]}
    positions, borders = create_regular_grid(area, t, stride)
    positions = positions_as_array(positions)
    wy, wx = blend.weight_table(t, stride, borders)
    b = len(positions)
    height = np.float32(412.375)
    inputs = (np.zeros((rows, cols), np.float32), np.zeros((b, t, t), np.float32),
              positions, wy, wx, np.full(b, height, np.float32))
    got = _plain(*inputs)
    region = got[3:61, 5:85]
    np.testing.assert_allclose(region, height, rtol=0, atol=_ulps(height))
    outside = np.ones_like(got, bool)
    outside[3:61, 5:85] = False
    assert np.all(got[outside] == 0)
    want = _jax("xla", *inputs)
    np.testing.assert_allclose(got, want, rtol=0, atol=_ulps(height))


def test_cpu_canvas_runs_plain_and_launches_nothing():
    inputs = _inputs(seed=5)
    want = _plain(*inputs)
    before = dict(stitch.LAUNCHES)
    for use_pallas in (None, True, False, "fused"):
        scene, tiles, positions, wy, wx, means = (torch.from_numpy(a.copy())
                                                  for a in inputs)
        stitch.stitch_tiles(scene, tiles, positions, wy, wx, means, SIGMA,
                            use_pallas=use_pallas)
        np.testing.assert_array_equal(scene.numpy(), want)
    scene, tiles, positions, wy, wx, means = (torch.from_numpy(a.copy())
                                              for a in inputs)
    stitch.stitch_tiles_fused(scene, tiles, positions, wy, wx, means, SIGMA)
    np.testing.assert_array_equal(scene.numpy(), want)
    assert stitch.LAUNCHES == before


def test_use_pallas_false_raises_on_cuda():
    """The plain stitch is the CPU reference only: no CUDA canvas runs it."""
    with pytest.raises(ValueError, match="CPU reference only"):
        stitch.validate_use_pallas(False, torch.device("cuda"))
    for value in (None, True, "fused"):
        stitch.validate_use_pallas(value, torch.device("cuda"))
    with pytest.raises(ValueError, match="use_pallas"):
        stitch.validate_use_pallas("atomic", torch.device("cpu"))


def _overlap_case():
    """chip_smoke's heavy-overlap case: 300 tiles of 16 px at random spots
    on a 96x128 canvas, up to 18 of them on a pixel."""
    return chip_smoke.overlap_batch(96, 128, 16, 300)


def _batch_inputs(batch, shape):
    return (np.zeros(shape, np.float32),
            *(batch[k].numpy() for k in ("tiles", "positions", "wy", "wx", "means")))


@pytest.mark.parametrize("kind", ["xla", "pallas_fused"])
def test_plain_matches_jax_on_heavy_overlap(kind):
    """More tiles than one of K2's scan rounds (256), many on each pixel."""
    batch = _overlap_case()
    assert chip_smoke.max_cover([batch], (96, 128)) >= 8
    inputs = _batch_inputs(batch, (96, 128))
    want = _jax(kind, *inputs, sigma=chip_smoke.DSM_STD)
    got = _plain(*inputs, sigma=chip_smoke.DSM_STD)
    np.testing.assert_allclose(got, want, rtol=0, atol=_ulps(want))


def test_free_order_needs_k1_bar():
    """K1's atomics add in no fixed order. On the heavy-overlap case a sum
    in a random tile order leaves 2 ulps of the ordered sum but stays
    within ``chip_smoke.k1_ulps``, K1's bar on the card."""
    batch = _overlap_case()
    inputs = _batch_inputs(batch, (96, 128))
    want = _plain(*inputs, sigma=chip_smoke.DSM_STD)
    pred = batch["tiles"] * torch.tensor(chip_smoke.DSM_STD) + batch["means"][:, None, None]
    weighted = (pred * (batch["wy"][:, :, None] * batch["wx"][:, None, :])).numpy()
    positions = batch["positions"].numpy()
    t = weighted.shape[1]
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(20):
        acc = np.zeros_like(want)
        for i in rng.permutation(len(positions)):
            y, x = positions[i]
            acc[y:y + t, x:x + t] += weighted[i]
        worst = max(worst, float(np.abs(acc - want).max()))
    ulp = _ulps(want, 1)
    bar = chip_smoke.k1_ulps(chip_smoke.max_cover([batch], want.shape))
    assert 2 * ulp < worst <= bar * ulp


@pytest.mark.parametrize("case", ["overlap", "ragged"])
def test_fused_on_cpu_runs_plain_with_bounds(case):
    """``stitch_tiles_fused`` with a box on a CPU canvas is the plain twin,
    bitwise, and launches nothing: B = 300, and a ragged 101x99 grid whose
    last batch is padded as the main path pads it."""
    if case == "overlap":
        shape, batches = (96, 128), [_overlap_case()]
    else:
        shape = (101, 99)
        batches = chip_smoke.grid_batches(*shape, tile=16, batch=7)
        assert batches[-1]["n_pad"] > 0
    want = torch.zeros(shape)
    got = torch.zeros(shape)
    before = dict(stitch.LAUNCHES)
    for batch in batches:
        args = [batch[k] for k in ("tiles", "positions", "wy", "wx", "means")]
        stitch.stitch_tiles_plain(want, *args, SIGMA)
        assert stitch.stitch_tiles_fused(got, *args, SIGMA,
                                         bounds=batch["bounds"]) is got
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert stitch.LAUNCHES == before


@pytest.mark.parametrize("shape,tile,offset,want", [
    ((64, 80), 16, 0, (True, True)),
    ((64, 81), 16, 0, (False, True)),
    ((64, 80), 18, 0, (True, False)),
    ((64, 80), 16, 1, (False, True)),      # canvas 4 bytes off alignment
], ids=["aligned", "odd-width", "odd-tile", "offset-canvas"])
def test_k2_vector_paths(shape, tile, offset, want):
    """K2's float4 paths follow from shapes and alignment alone."""
    storage = torch.zeros(offset + shape[0] * shape[1])
    scene = storage[offset:].view(shape)
    tiles = torch.zeros((3, tile, tile))
    wx = torch.zeros((3, tile))
    assert stitch.k2_vector_paths(scene, tiles, wx) == want
