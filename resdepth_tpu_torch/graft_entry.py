"""The flagship forward and the multichip dry run: the port of
``__graft_entry__.py``.

    python -m resdepth_tpu_torch.graft_entry [--n N] [--cpu] [--share-cards]

runs ``entry()``'s forward, then ``dryrun_multichip(N)`` (N defaults to 8,
as the JAX script's ``dryrun_multichip(8)``).

``entry(device)`` returns the flagship forward and its example input, as
the JAX ``entry()`` does: ``fn(model, x)`` runs the ResDepth-stereo UNet
(depth 5, start 64, cap 512; seeded weights, eval mode) on ``x``, four
256x256 tiles of 3 channels from ``np.random.default_rng(0)``.

``dryrun_multichip(n)`` runs the JAX dry run's legs, with its seeds, shapes
and configs, in a world of ``n`` processes, one a rank
(``parallel.bootstrap``, the ``RESDEPTH_DIST_*`` launch), each leg on the
group of ``parallel.mesh.data_mesh``:

* ``train``: one data-parallel train step (64^2 rasters, 32-px tiles,
  batch 2n, depth 3, start 8, cap 32, augmentation and view permutation
  on, Adam) at the training policy ``policy``;
* ``banded``: one step on each of the first two windows of banded
  residency (96x64, 16-px tiles, a budget of 1600 px: 2-D windows, columns
  cut), two uploads, nothing resident after;
* ``tile-sharded``: a 64x96 scene's tiles shared over the ranks at batch 2
  (``predict_linear_blend(group=)``), at tta 1 and at tta 4 with the median
  merge, against the one-process scene;
* ``scene-sharded``: a 128x64 scene's row bands over the ranks under a
  budget of one tile-high band (``predict_linear_blend_scene_sharded``,
  K2's order) against the resident scene;
* ``train-2d``, where n is even and at least 4: the train leg on the
  (dcn, ici) mesh of 2 slices (``data_mesh_2d``).

Its bars are tighter than the JAX script's ``atol=1e-3``: every rank's
weights and BatchNorm statistics bitwise the others' after a step, the
metric finite and the step count 1; the tile-sharded scene within K1's
bar (2 f32 ulps of the largest height, half the cover where more than 4
tiles meet) of the one-process scene, bitwise for a world of one on the
CPU (more ranks regroup each pixel's sum); the scene-sharded scene bitwise
the resident one off the rows two bands share and within 2 ulps on them.

Ranks run over NCCL, one a card, where ``n`` is at most the visible card
count; with ``share_cards`` they sit round-robin on the cards over gloo
(several ranks a card); with ``device="cpu"`` they are ``n`` gloo
processes on the CPU. Asked for more cards than there are, without
``share_cards``, it raises: it never falls back to the CPU, as the JAX
script falls back to virtual CPU devices. The train legs run ``policy``
(``tpu.train_precision``; 'default' puts K3 at 1 pass on the forward and
dx of the 3x3 convs on the card); the tile-sharded leg stitches with K1
(``use_pallas`` unset), the scene-sharded leg with K2 (``"fused"``, the
plain stitch's order, which its bitwise bar needs). On the CPU the plain
versions run. Each world runs under a timeout
(``bootstrap.run_world``): a rank that fails or hangs stops the others,
and the error names the first leg that did not finish.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from resdepth_tpu_torch.parallel import bootstrap, mesh

WORLD_TIMEOUT = 900          # seconds a dry run's world may take
COLLECTIVE_TIMEOUT = 300     # seconds a collective waits for its peers
SEAM_ULPS = 2                # the scene-sharded scene on the rows two bands share
GEOTRANSFORM = (1000.0, 0.25, 0.0, 2000.0, 0.0, -0.25)
RANK_MODULE = [sys.executable, "-m", "resdepth_tpu_torch.graft_entry", "--rank"]


def entry(device=None):
    """``(fn, (model, x))``: the flagship forward and its example input.

    ``model`` is ``init_unet(flagship_config("geom-stereo"),
    torch.Generator().manual_seed(0))`` in eval mode on ``device`` (default:
    the card; raises without CUDA), ``x`` a (4, 256, 256, 3) float32 numpy
    array; ``fn(model, x)`` returns the (4, 256, 256, 1) prediction on the
    model's device (``x`` may be a tensor already there)."""
    from resdepth_tpu_torch.models.unet import apply_unet, flagship_config, init_unet
    from resdepth_tpu_torch.predict import resolve_device

    device = resolve_device("cuda" if device is None else str(torch.device(device).type))
    model = init_unet(flagship_config("geom-stereo"), torch.Generator().manual_seed(0),
                      device).eval()

    @torch.no_grad()
    def forward(model, x):
        return apply_unet(model, torch.as_tensor(x, device=model.device))

    x = np.random.default_rng(0).normal(size=(4, 256, 256, 3)).astype(np.float32)
    return forward, (model, x)


# --------------------------------- the legs --------------------------------- #

def legs(n: int) -> list:
    """The dry run's legs for a world of ``n``, in order."""
    return (["train", "banded", "tile-sharded", "scene-sharded"]
            + (["train-2d"] if n % 2 == 0 and n >= 4 else []))


def _zero_counters() -> None:
    from resdepth_tpu_torch.ops import conv, stitch

    for counters in (conv.LAUNCHES, stitch.LAUNCHES):
        for key in counters:
            counters[key] = 0


def _counters() -> dict:
    """The kernel launches since ``_zero_counters``: "k1", "k2", and K3 by
    float32 pass count ("k3_p1" .. "k3_p3") and in bf16 ("k3")."""
    from resdepth_tpu_torch.ops import conv, stitch

    return {**stitch.LAUNCHES, **conv.LAUNCHES}


def _digest(model) -> str:
    """sha256 of every parameter and buffer, bit for bit."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _write_tif(tmp: str, name: str, data: np.ndarray) -> str:
    from resdepth_tpu_torch.geo import tiff

    path = os.path.join(tmp, name)
    tiff.write(path, data, geotransform=GEOTRANSFORM, nodata=-9999.0)
    return path


def _ulps(reference: np.ndarray, n: float) -> float:
    return n * float(np.spacing(np.float32(np.abs(reference).max())))


def leg_train(n: int, device, group, policy: str = "default") -> dict:
    """One data-parallel train step: ``__graft_entry__.py::_dryrun_train_step``'s
    rasters, batch and model. The JAX key 7 becomes each rank's generator
    seed (``train.trainer.epoch_seed(7, 0, rank)``)."""
    from resdepth_tpu_torch.data.pipeline import BatchSpec, DeviceRasters, GeneratorDraws
    from resdepth_tpu_torch.models.unet import UNetConfig, init_unet
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)
    from resdepth_tpu_torch.train.trainer import epoch_seed

    rng = np.random.default_rng(0)
    rows = cols = 64
    tile, batch = 32, 2 * n
    gt = rng.normal(400.0, 5.0, (rows, cols)).astype(np.float32)
    dsm = gt + rng.normal(0.0, 1.0, (rows, cols)).astype(np.float32)
    orthos = rng.normal(120.0, 25.0, (rows, cols, 3)).astype(np.float32)
    rasters = DeviceRasters(
        dsm_input=torch.from_numpy(dsm).to(device), dsm_target=torch.from_numpy(gt).to(device),
        orthos=torch.from_numpy(orthos.transpose(2, 0, 1).copy()).to(device),
        pairs=torch.tensor([[0, 1], [1, 2]], dtype=torch.int64, device=device),
        nodata=-9999.0)
    config = UNetConfig(n_input_channels=3, start_kernel=8, max_filter_depth=32, depth=3)
    spec = BatchSpec(input_channels="geom-stereo", tile_size=tile, dsm_std=5.0,
                     permute_images_within_pair=True, augment=True)
    model = init_unet(config, torch.Generator().manual_seed(0), device)
    kwargs, dtype = select_train_precision(policy, None, device)
    state = init_train_state(model, "Adam", 2e-4, 1e-5)
    step = make_train_step(spec, compute_dtype=dtype, group=group, **kwargs)
    positions = rng.integers(0, rows - tile, (batch, 2)).astype(np.int32)
    pair_idx = rng.integers(0, 2, batch).astype(np.int32)
    draws = GeneratorDraws(torch.Generator(device=device).manual_seed(
        epoch_seed(7, 0, mesh.rank(group))))
    metric = float(step(state, rasters, positions, pair_idx, np.zeros((batch, 4), np.int32),
                        np.ones(batch, np.float32), draws))
    if not np.isfinite(metric) or state.step != 1:
        raise AssertionError(f"train step: metric {metric}, step {state.step}")
    return {"metric": metric, "step": state.step, "digest": _digest(model)}


def leg_banded(n: int, device, group, policy: str = "default") -> dict:
    """One step on each of the first two 2-D windows of banded residency
    (``_dryrun_banded_train``): two uploads, nothing resident after."""
    from resdepth_tpu_torch.data import banded
    from resdepth_tpu_torch.data.dataset import TileDataset
    from resdepth_tpu_torch.data.pipeline import GeneratorDraws, batch_spec_for
    from resdepth_tpu_torch.models.unet import UNetConfig, init_unet
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)
    from resdepth_tpu_torch.train.trainer import epoch_seed

    rng = np.random.default_rng(3)
    rows, cols, tile = 96, 64, 16
    gt = rng.normal(400.0, 5.0, (rows, cols)).astype(np.float32)
    dsm = gt + rng.normal(0.0, 1.0, (rows, cols)).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="dryrun_banded_")   # this rank's own copy
    try:
        entry_ = {"raster_in": _write_tif(tmp, "dsm.tif", dsm),
                  "raster_gt": _write_tif(tmp, "gt.tif", gt),
                  "area_defn": {"x_extent": [(0, cols - 1)], "y_extent": [(0, rows - 1)]},
                  "n_samples": 4 * n}
        ds = TileDataset(entry_, input_channels="geom", tile_size=tile,
                         sampling_strategy="train", dsm_std=5.0, seed=0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # Below one full-width tile-high band (2 planes x 64 cols x 16 rows =
    # 2048 px): the windows cut the columns too.
    budget = 1600
    if not banded.resident_pixels(ds) > budget:
        raise AssertionError("banded: the scene fits the budget")
    loaders = banded.make_banded_loaders(ds, 2 * n, max_device_pixels=budget, seed=1,
                                         device=device)
    if len(loaders) < 2 or len({p.x0 for p, _ in loaders}) < 2:
        raise AssertionError(f"banded: {len(loaders)} windows, columns cut "
                             f"{len({p.x0 for p, _ in loaders}) > 1}")
    config = UNetConfig(n_input_channels=1, start_kernel=8, max_filter_depth=32, depth=2)
    model = init_unet(config, torch.Generator().manual_seed(0), device)
    kwargs, dtype = select_train_precision(policy, None, device)
    state = init_train_state(model, "Adam", 2e-4, 1e-5)
    step = make_train_step(batch_spec_for(ds), compute_dtype=dtype, group=group, **kwargs)
    draws = GeneratorDraws(torch.Generator(device=device).manual_seed(
        epoch_seed(7, 0, mesh.rank(group))))
    metrics = []
    for provider, iterator in loaders[:2]:
        positions, pair_idx, bounds, weights = next(iter(iterator))
        metrics.append(float(step(state, provider.resolve(), positions, pair_idx, bounds,
                                  weights, draws)))
        provider.release()
    source = loaders[0][0].source
    if not (np.isfinite(metrics).all() and source.uploads == 2
            and source._resident is None and state.step == 2):
        raise AssertionError(f"banded: metrics {metrics}, uploads {source.uploads}, "
                             f"resident {source._resident is not None}")
    return {"metric": metrics[-1], "step": state.step, "digest": _digest(model),
            "windows": len(loaders),
            "window": [source.window_rows, source.window_cols]}


def _stitch_bar(ds, ranks: int, device) -> float:
    """The tile-sharded scene's bar against one process, in f32 ulps: 0
    (bitwise) for a world of one on the CPU (the plain stitch), else K1's:
    2, or half the largest cover."""
    if ranks == 1 and torch.device(device).type == "cpu":
        return 0
    tile = ds.tile_size
    cover = np.zeros(ds.dsm_input.shape, np.int32)
    for y, x in ds.positions:
        cover[y:y + tile, x:x + tile] += 1
    return max(2, -(-int(cover.max()) // 2))


def leg_tile_sharded(n: int, device, group) -> dict:
    """``_dryrun_sharded_inference``: the tile-sharded scene at tta 1 and at
    tta 4 (median) against the one-process scene, with K1 on the card. The
    counters hold the sharded runs' launches only."""
    from resdepth_tpu_torch.data.dataset import TileDataset
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend
    from resdepth_tpu_torch.models.unet import UNetConfig, init_unet

    rng = np.random.default_rng(1)
    rows, cols, tile = 64, 96, 32
    gt = rng.normal(400.0, 5.0, (rows, cols)).astype(np.float32)
    dsm = gt + rng.normal(0.0, 1.0, (rows, cols)).astype(np.float32)
    images = rng.normal(120.0, 25.0, (rows, cols, 2)).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="dryrun_tiled_")
    try:
        entry_ = {"raster_in": _write_tif(tmp, "dsm.tif", dsm),
                  "image_list": [_write_tif(tmp, f"img{j}.tif", images[..., j])
                                 for j in range(2)],
                  "image_pairs": [(0, 1)],
                  "area_defn": {"x_extent": [(0, cols - 1)], "y_extent": [(0, rows - 1)]}}
        ds = TileDataset(entry_, input_channels="geom-stereo", tile_size=tile,
                         sampling_strategy="test", dsm_std=5.0, ortho_mean=120.0,
                         ortho_std=25.0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    config = UNetConfig(n_input_channels=3, start_kernel=8, max_filter_depth=32, depth=3)
    model = init_unet(config, torch.Generator().manual_seed(2))
    common = dict(device=device, batch_size=2)
    bar = _stitch_bar(ds, mesh.size(group), device)
    out, launches = {}, {}
    for name, kwargs in (("tta1", {}), ("tta4-median", dict(tta=4, tta_merge="median"))):
        single = predict_linear_blend(model, ds, **common, **kwargs)
        _zero_counters()
        sharded = predict_linear_blend(model, ds, group=group, **common, **kwargs)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        for key, value in _counters().items():
            launches[key] = launches.get(key, 0) + value
        diff = float(np.abs(sharded.astype(np.float64) - single).max()) / _ulps(single, 1)
        if not (np.isfinite(sharded).all() and diff <= bar):
            raise AssertionError(f"tile-sharded {name}: {diff:.3g} ulps from one process "
                                 f"(bar {bar})")
        out[name] = diff
    return {"ulps": out, "bar": bar, "tiles": len(ds.positions), "launches": launches}


def _band_windows(ds, budget: int) -> list:
    """The (start, stop) rows of the scene loop's row bands under ``budget``."""
    from resdepth_tpu_torch.infer.tiled import _iter_bands, _rows_budget

    return [(w.start, w.stop) for w, _, _ in _iter_bands(ds, _rows_budget(ds, budget))]


def _seam_rows(windows: list, rows: int) -> np.ndarray:
    """The rows two bands' windows share."""
    seams = np.zeros(rows, bool)
    for (_, stop), (start, _) in zip(windows, windows[1:]):
        seams[start:stop] = True
    return seams


def leg_scene_sharded(n: int, device, group) -> dict:
    """``_dryrun_scene_sharded``: row bands over the ranks with K2 against
    the resident scene (bitwise off the seam rows, ``SEAM_ULPS`` on them),
    on the chief, which alone holds the scene."""
    from resdepth_tpu_torch.data.dataset import TileDataset
    from resdepth_tpu_torch.infer.tiled import (predict_linear_blend,
                                                predict_linear_blend_scene_sharded)
    from resdepth_tpu_torch.models.unet import UNetConfig, init_unet

    rng = np.random.default_rng(3)
    rows, cols, tile = 128, 64, 32
    dsm = rng.normal(400.0, 5.0, (rows, cols)).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="dryrun_scene_")
    try:
        entry_ = {"raster_in": _write_tif(tmp, "dsm.tif", dsm),
                  "area_defn": {"x_extent": [(0, cols - 1)], "y_extent": [(0, rows - 1)]}}
        ds = TileDataset(entry_, input_channels="geom", tile_size=tile,
                         sampling_strategy="test", dsm_std=5.0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    config = UNetConfig(n_input_channels=1, start_kernel=8, max_filter_depth=32, depth=3)
    model = init_unet(config, torch.Generator().manual_seed(4))
    common = dict(device=device, batch_size=2, use_pallas="fused")
    budget = tile * cols    # one tile-high band a rank's window
    resident = predict_linear_blend(model, ds, **common)
    _zero_counters()
    sharded = predict_linear_blend_scene_sharded(model, ds, max_device_pixels=budget,
                                                 group=group, **common)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = _counters()
    result = {"launches": launches, "holds_scene": sharded is not None}
    if mesh.rank(group) != 0:
        return result
    windows = _band_windows(ds, budget)
    seams = _seam_rows(windows, rows)
    seam = float(np.abs(sharded[seams].astype(np.float64) - resident[seams]).max()
                 ) / _ulps(resident, 1)
    off = bool(np.array_equal(sharded[~seams], resident[~seams]))
    if not (np.isfinite(sharded).all() and off and seam <= SEAM_ULPS):
        raise AssertionError(f"scene-sharded: bitwise off the seams {off}, {seam:.3g} "
                             f"ulps on them (bar {SEAM_ULPS})")
    return {**result, "seam_ulps": seam, "seam_rows": int(seams.sum()),
            "bands": len(windows)}


def run_legs(n: int, device, group, policy: str = "default",
             progress: str | None = None) -> dict:
    """Every leg of ``legs(n)`` on this rank, in order, each with the launch
    counters zeroed just before its counted work and read just after;
    ``progress``: a file that gets each finished leg's name on a line."""
    out = {}
    for name in legs(n):
        start = time.perf_counter()
        if name in ("train", "banded", "train-2d"):
            _zero_counters()
            fn = leg_banded if name == "banded" else leg_train
            leg_group = mesh.data_mesh_2d(2, n) if name == "train-2d" else group
            result = fn(n, device, leg_group, policy)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            result["launches"] = _counters()
        elif name == "tile-sharded":
            result = leg_tile_sharded(n, device, group)
        else:
            result = leg_scene_sharded(n, device, group)
        result["seconds"] = time.perf_counter() - start
        out[name] = result
        if progress:
            with open(progress, "a") as f:
                f.write(name + "\n")
    return out


# ------------------------------- the world ---------------------------------- #

def rank_main(plan_path: str) -> dict:
    """One rank: joins the world through ``RESDEPTH_DIST_*`` on the plan's
    device and backend, runs the legs and writes ``<out>.r<rank>.json``."""
    with open(plan_path) as f:
        plan = json.load(f)
    device_type = plan["device"]
    if device_type == "cpu":
        torch.set_num_threads(2)
    if not bootstrap.maybe_initialize_distributed(
            device=device_type, backend=plan["backend"],
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT)):
        raise RuntimeError("a dry-run rank needs RESDEPTH_DIST_*")
    group = mesh.data_mesh(plan["n"])
    rank = mesh.rank(group)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        results = run_legs(plan["n"], device, group, plan["policy"],
                           progress=f"{plan['out']}.r{rank}.progress")
        with open(f"{plan['out']}.r{rank}.json", "w") as f:
            json.dump({"rank": rank, "world": mesh.size(group),
                       "backend": torch.distributed.get_backend(group),
                       "device": str(device), "legs": results}, f)
    finally:
        torch.distributed.destroy_process_group()
    return results


def _first_unfinished(plan: dict) -> str | None:
    done = []
    for rank in range(plan["n"]):
        path = f"{plan['out']}.r{rank}.progress"
        with open(path) if os.path.exists(path) else open(os.devnull) as f:
            done.append(f.read().split())
    for name in legs(plan["n"]):
        if not all(name in d for d in done):
            return name
    return None


def _check_world(n: int, results: list) -> list:
    """The cross-rank checks; returns the legs' report lines."""
    lines = []
    for name in legs(n):
        ranks = [r["legs"][name] for r in results]
        if "digest" in ranks[0]:
            if len({r["digest"] for r in ranks}) != 1 or {r["step"] for r in ranks} != \
                    {ranks[0]["step"]}:
                raise AssertionError(f"dryrun_multichip({n}) {name}: the ranks' weights "
                                     "or step counts differ")
            mesh_desc = ("2x%d (dcn, ici) mesh" % (n // 2) if name == "train-2d"
                         else f"{n}-rank group")
            extra = (f" over {ranks[0]['windows']} 2-D band windows "
                     f"({ranks[0]['window'][0]}x{ranks[0]['window'][1]})"
                     if name == "banded" else "")
            lines.append(f"{name}: DP train step{'s' if name == 'banded' else ''} OK on the "
                         f"{mesh_desc}{extra}, masked MAE = {ranks[0]['metric']:.4f} m, "
                         "weights bitwise equal on every rank")
        elif name == "tile-sharded":
            lines.append(f"tile-sharded inference OK, {ranks[0]['tiles']} tiles over {n} "
                         f"ranks == one process within {ranks[0]['bar']} ulps (tta 1: "
                         f"{ranks[0]['ulps']['tta1']:.2f}, tta 4 median: "
                         f"{ranks[0]['ulps']['tta4-median']:.2f})")
        else:
            if [r["holds_scene"] for r in ranks] != [True] + [False] * (n - 1):
                raise AssertionError(f"dryrun_multichip({n}) scene-sharded: the chief "
                                     "alone should hold the scene")
            lines.append(f"scene-sharded inference OK, {ranks[0]['bands']} row bands over "
                         f"{n} ranks == resident scene (bitwise off the "
                         f"{ranks[0]['seam_rows']} seam rows, {ranks[0]['seam_ulps']:.2f} "
                         "ulps on them)")
    return lines


def dryrun_multichip(n: int, *, device: str = "cuda", share_cards: bool = False,
                     policy: str = "default", rank_argv: list | None = None,
                     timeout: float = WORLD_TIMEOUT) -> list:
    """Run the dry run's legs in a world of ``n`` ranks (see the module's
    docstring); returns each rank's results (``"legs"``: name -> its
    numbers and ``"launches"``). ``rank_argv``: the command a rank runs,
    before the plan file (default ``python -m resdepth_tpu_torch.graft_entry
    --rank``; a caller that wraps the legs gives its own)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    cards = 0
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"dryrun_multichip({n}): CUDA is not available (pass "
                               "device='cpu' for gloo ranks on the CPU)")
        cards = torch.cuda.device_count()
        if n > cards and not share_cards:
            raise RuntimeError(f"dryrun_multichip({n}): {cards} visible card(s) for "
                               f"{n} ranks; pass share_cards=True to place several "
                               "ranks on a card (over gloo)")
    backend = "nccl" if device == "cuda" and not share_cards else "gloo"
    work = tempfile.mkdtemp(prefix="dryrun_")
    plan = {"n": n, "device": device, "backend": backend, "cards": cards,
            "policy": policy, "out": os.path.join(work, "dryrun")}
    plan_path = os.path.join(work, "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    try:
        bootstrap.run_world(
            (rank_argv or RANK_MODULE) + [plan_path], n, timeout=timeout, log_dir=work,
            local_rank=None if device == "cpu" else
            (lambda r: r % cards) if backend == "gloo" else (lambda r: r))
        results = []
        for rank in range(n):
            with open(f"{plan['out']}.r{rank}.json") as f:
                results.append(json.load(f))
    except bootstrap.WorldFailed as exc:
        raise RuntimeError(f"dryrun_multichip({n}): leg {_first_unfinished(plan)!r} "
                           f"failed: {exc}") from None
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if [(r["rank"], r["world"], r["backend"]) for r in results] != [
            (i, n, backend) for i in range(n)]:
        raise AssertionError(f"dryrun_multichip({n}): the ranks reported "
                             f"{[(r['rank'], r['world'], r['backend']) for r in results]}")
    where = (f"{n} {backend} process{'es' if n > 1 else ''} on "
             + ("the CPU" if device == "cpu" else f"{min(n, cards)} card(s)"))
    for line in _check_world(n, results):
        print(f"dryrun_multichip({n}) [{where}]: {line}", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8, help="ranks of the dry run (default 8)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo ranks)")
    ap.add_argument("--share-cards", action="store_true",
                    help="place several ranks on a card, over gloo")
    ap.add_argument("--rank", metavar="PLAN", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        rank_main(args.rank)
        return 0
    device = "cpu" if args.cpu else "cuda"
    fn, (model, x) = entry(device)
    out = fn(model, x)
    print("entry forward:", tuple(out.shape), out.dtype)
    dryrun_multichip(args.n, device=device, share_cards=args.share_cards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
