"""One rank of the port's data-parallel world on the CPU, for
``tests/test_torch_parallel.py``.

    RESDEPTH_DIST_COORDINATOR=localhost:PORT RESDEPTH_DIST_NUM_PROCESSES=2 \\
    RESDEPTH_DIST_PROCESS_ID=R python tests/_torch_parallel_worker.py PLAN.json

Joins the gloo group through ``parallel.bootstrap.maybe_initialize_distributed``
(the env-triggered path, a 60 s timeout on every collective), runs each
task of the plan on this rank's share and writes ``<out>.r<rank>.npz``.
It cannot import JAX or the JAX package: the port must run without them.
"""

import sys


class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "resdepth_tpu"):
            raise ImportError(f"{name}: the port must not import JAX")
        return None


sys.meta_path.insert(0, _BlockJax())

import datetime  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from resdepth_tpu_torch.data.dataset import TileDataset  # noqa: E402
from resdepth_tpu_torch.data.pipeline import (BatchSpec, DeviceRasters,  # noqa: E402
                                              GeneratorDraws)
from resdepth_tpu_torch.infer import tiled  # noqa: E402
from resdepth_tpu_torch.models import unet  # noqa: E402
from resdepth_tpu_torch.parallel import bootstrap, mesh  # noqa: E402
from resdepth_tpu_torch.train.step import (init_train_state,  # noqa: E402
                                           make_train_step, select_train_precision)


def toy_rasters(arrays) -> DeviceRasters:
    """The toy training scene (geom input, no orthos) on the CPU."""
    return DeviceRasters(torch.from_numpy(arrays["dsm"]), torch.from_numpy(arrays["gt"]),
                         None, torch.zeros((1, 0), dtype=torch.int64), -9999.0)


def toy_spec(tile: int) -> BatchSpec:
    return BatchSpec(input_channels="geom", tile_size=tile, dsm_std=3.0)


def model_from(settings: dict, state: dict) -> unet.UNet:
    model = unet.UNet(unet.UNetConfig(**settings))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def run_train(task: dict, arrays, group) -> dict:
    """``task["steps"]`` Adam steps of ``make_train_step`` on the global
    batch (this rank's shard) -> metrics and the state dict after."""
    model = model_from(task["settings"], {k[6:]: arrays[k] for k in arrays.files
                                          if k.startswith("state.")})
    kwargs, dtype = select_train_precision(task["policy"], None, torch.device("cpu"))
    state = init_train_state(model, "Adam", task["lr"], 1e-5)
    step = make_train_step(toy_spec(task["tile"]), weighted_bn=True, compute_dtype=dtype,
                           group=group, **kwargs)
    rasters = toy_rasters(arrays)
    batch = (arrays["positions"], np.zeros(len(arrays["positions"]), np.int32),
             np.zeros((len(arrays["positions"]), 4), np.int32), arrays["weights"])
    metrics = [float(step(state, rasters, *batch,
                          GeneratorDraws(torch.Generator().manual_seed(0))))
               for _ in range(task["steps"])]
    return {"metrics": np.asarray(metrics),
            **{f"state.{k}": v.numpy() for k, v in model.state_dict().items()}}


def run_bn(task: dict, arrays, group) -> dict:
    """dx of a training-mode BatchNorm on this rank's share of the global
    (x, g), with the statistics' all-reduce as the port takes it, and with
    one whose backward passes the gradient through unreduced, as
    ``torch.distributed.all_reduce`` under autograd would (each rank's dx
    then misses the other ranks' share of the statistics' gradient)."""
    n = mesh.size(group)
    share = len(arrays["x"]) // n
    rows = slice(mesh.rank(group) * share, (mesh.rank(group) + 1) * share)
    out = {}
    for name in ("port", "local_grad"):
        bn = torch.nn.BatchNorm2d(arrays["x"].shape[1])
        x = torch.from_numpy(arrays["x"][rows]).requires_grad_(True)
        weights = torch.from_numpy(arrays["weights"][rows])
        all_reduce_sum = mesh.all_reduce_sum
        if name == "local_grad":
            mesh.all_reduce_sum = lambda t, g: t + (
                mesh.all_reduce_(t.detach().clone(), g) - t.detach())
        try:
            y, _, _ = unet.batch_norm_train(bn, x, weights, group)
        finally:
            mesh.all_reduce_sum = all_reduce_sum
        (y * torch.from_numpy(arrays["g"][rows])).sum().backward()
        out[f"dx.{name}"] = x.grad.numpy()
    return out


def scene_dataset(task: dict) -> TileDataset:
    entry = dict(task["entry"], image_pairs=[tuple(p) for p in task["entry"]["image_pairs"]])
    return TileDataset(entry, input_channels="geom-stereo",
                       tile_size=task["tile"], sampling_strategy="test",
                       dsm_std=5.0, ortho_mean=120.0, ortho_std=25.0)


def run_infer(task: dict, arrays, group) -> dict:
    """The tile-sharded scene (``predict_linear_blend``), the streamed one
    and the scene-sharded one under the group."""
    model = model_from(task["settings"], {k[6:]: arrays[k] for k in arrays.files
                                          if k.startswith("state.")})
    ds = scene_dataset(task)
    common = dict(device="cpu", batch_size=task["batch_size"])
    out = {"tiled": tiled.predict_linear_blend(model, ds, tta=2, tta_merge="median",
                                               group=group, **common),
           "streamed": tiled.predict_linear_blend_streaming(
               model, ds, max_device_pixels=task["budget"], group=group, **common)}
    sharded = tiled.predict_linear_blend_scene_sharded(
        model, ds, max_device_pixels=task["sharded_budget"], group=group, **common)
    out["sharded_is_none"] = np.asarray(sharded is None)
    if sharded is not None:
        out["sharded"] = sharded
    return out


TASKS = {"train": run_train, "bn": run_bn, "infer": run_infer}


def main() -> None:
    with open(sys.argv[1]) as f:
        plan = json.load(f)
    torch.set_num_threads(2)
    if not bootstrap.maybe_initialize_distributed(
            device="cpu", timeout=datetime.timedelta(seconds=60)):
        raise SystemExit("no RESDEPTH_DIST_* launch: nothing to join")
    group = mesh.data_mesh()
    rank = bootstrap.process_index()
    for task in plan["tasks"]:
        arrays = np.load(task["inputs"])
        result = TASKS[task["kind"]](task, arrays, group)
        np.savez(f"{task['out']}.r{rank}.npz", **result)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
