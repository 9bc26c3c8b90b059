"""Generate a self-contained demo scene and ready-to-run configs (the
port's copy of ``scripts/make_demo_data.py``).

    python -m resdepth_tpu_torch.make_demo_data [output_dir]     # default ./demo
    python -m resdepth_tpu_torch.train <output_dir>/config_train.json [--device cpu]
    # edit the four EDIT: paths in config_test.json to the run directory, then
    python -m resdepth_tpu_torch.predict <output_dir>/config_test.json [--device cpu]

(``resdepth_tpu_torch/run_demo.sh`` does all of it.) The scene is synthetic
(``utils/synth.py``): a seeded city ground-truth DSM (terrain and building
blocks), a noisy initial DSM, three hillshade pseudo ortho views, building
and water masks, image and pair lists, and train and inference JSON
configs wired to the files. The GeoTIFFs and lists are byte for byte the
JAX script's; the configs differ only in the directory they name.
``write_golden_scene`` writes the smaller golden scene of
``make_demo_goldens.py``.
"""

from __future__ import annotations

import json
import os
import sys

from resdepth_tpu_torch.geo import tiff
from resdepth_tpu_torch.utils.synth import GSD, NODATA, hillshade, synth_city


def write_golden_scene(out_dir: str) -> dict:
    """Small deterministic scene + configs for the committed-goldens flow.

    The reference ships expected demo outputs (demo/results_expected,
    README.md:535-539) for regression comparison; this is the equivalent:
    a seeded 160x160 scene and a fast train config (depth-3 UNet, 32 px
    tiles, 4 epochs) whose refined-DSM output is committed under
    tests/goldens/ and re-checked by tests/test_demo_goldens.py.
    Returns {"train": <train cfg path>, "test": <test cfg path>}.
    """
    os.makedirs(out_dir, exist_ok=True)
    geotransform = (465000.0, GSD, 0.0, 5247000.0, 0.0, -GSD)
    rows, cols = 160, 160
    gt, dsm, building, water = synth_city(rows, cols, seed=11)

    def write(name, data, nodata=NODATA):
        path = os.path.join(out_dir, name)
        tiff.write(path, data, geotransform=geotransform, nodata=nodata)
        return os.path.abspath(path)

    paths = {
        "gt": write("ground_truth_DSM.tif", gt),
        "dsm": write("initial_DSM.tif", dsm),
        "building": write("mask_building.tif", building, nodata=255),
        "water": write("mask_water.tif", water, nodata=255),
    }
    image_paths = [write(f"ortho_{az}.tif", hillshade(gt, az))
                   for az in (315, 135)]
    out_abs = os.path.abspath(out_dir)
    with open(os.path.join(out_dir, "imagelist.txt"), "w") as f:
        f.write("\n".join(image_paths) + "\n")
    with open(os.path.join(out_dir, "pairlist.txt"), "w") as f:
        f.write("ortho_315, ortho_135\n")

    train_cfg = {
        "datasets": [{
            "name": "golden_city",
            "raster_gt": paths["gt"],
            "raster_in": paths["dsm"],
            "path_image_list": os.path.join(out_abs, "imagelist.txt"),
            "path_pairlist_training": os.path.join(out_abs, "pairlist.txt"),
            "path_pairlist_validation": os.path.join(out_abs, "pairlist.txt"),
            "area_type": "train+val",
            "allocation_strategy": "5-crossval_vertical",
            "test_stripe": 1,
            "n_training_samples": 64,
        }],
        "model": {"input_channels": "geom-stereo", "depth": 3,
                  "start_kernel": 8, "max_filter_depth": 32},
        "stereopair_settings": {"use_all_stereo_pairs": False,
                                "permute_images_within_pair": False},
        "training_settings": {"tile_size": 32, "batch_size": 8, "n_epochs": 4,
                              "augment": True, "loss": "L1"},
        "optimizer": {"name": "Adam", "learning_rate": 0.0005},
        "scheduler": {"enabled": True, "name": "StepLR",
                      "settings": {"step_size": 2}},
        "general": {"save_model_rate": 10, "evaluate_rate": 1,
                    "random_seed": 0},
        "output": {"output_directory": os.path.join(out_abs, "runs")},
    }
    train_path = os.path.join(out_dir, "config_train.json")
    with open(train_path, "w") as f:
        json.dump(train_cfg, f, indent=2)

    test_cfg = {
        "datasets": [{
            "name": "golden_city",
            "raster_gt": paths["gt"],
            "raster_in": paths["dsm"],
            "path_image_list": os.path.join(out_abs, "imagelist.txt"),
            "path_pairlist": os.path.join(out_abs, "pairlist.txt"),
            "mask_building": paths["building"],
            "mask_water": paths["water"],
            "allocation_strategy": "5-crossval_vertical",
            "test_stripe": 1,
            "area_type": "test",
        }],
        # model artifact paths are filled in after training (run dir is
        # timestamped) — see fill_golden_test_config().
        "model": {},
        "general": {"tile_size": 32},
        "output": {"directory": os.path.join(out_abs, "eval")},
    }
    test_path = os.path.join(out_dir, "config_test.json")
    with open(test_path, "w") as f:
        json.dump(test_cfg, f, indent=2)
    return {"train": train_path, "test": test_path, "out": out_abs}


def fill_golden_test_config(test_cfg_path: str, run_dir: str) -> None:
    with open(test_cfg_path) as f:
        cfg = json.load(f)
    cfg["model"] = {
        "weights": os.path.join(run_dir, "checkpoints", "Model_best.npz"),
        "architecture": os.path.join(run_dir, "model_config.json"),
        "normalization_geom": os.path.join(
            run_dir, "DSM_normalization_parameters.p"),
        "normalization_image": os.path.join(
            run_dir, "Image_normalization_parameters.p"),
    }
    with open(test_cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else "demo"
    os.makedirs(out_dir, exist_ok=True)
    geotransform = (465000.0, GSD, 0.0, 5247000.0, 0.0, -GSD)

    rows, cols = 448, 640
    gt, dsm, building, water = synth_city(rows, cols)

    def write(name, data, nodata=NODATA):
        path = os.path.join(out_dir, name)
        tiff.write(path, data, geotransform=geotransform, nodata=nodata)
        return path

    paths = {
        "gt": write("ground_truth_DSM.tif", gt),
        "dsm": write("initial_DSM.tif", dsm),
        "building": write("mask_building.tif", building, nodata=255),
        "water": write("mask_water.tif", water, nodata=255),
    }
    image_paths = [write(f"ortho_{az}.tif", hillshade(gt, az))
                   for az in (315, 135, 45)]

    with open(os.path.join(out_dir, "imagelist.txt"), "w") as f:
        f.write("\n".join(os.path.abspath(p) for p in image_paths) + "\n")
    with open(os.path.join(out_dir, "pairlist_stereo.txt"), "w") as f:
        f.write("ortho_315, ortho_135\northo_315, ortho_45\n")
    with open(os.path.join(out_dir, "pairlist_test.txt"), "w") as f:
        f.write("ortho_315, ortho_135\n")

    absolute = {k: os.path.abspath(v) for k, v in paths.items()}
    out_abs = os.path.abspath(out_dir)

    train_cfg = {
        "datasets": [{
            "name": "demo_city",
            "raster_gt": absolute["gt"],
            "raster_in": absolute["dsm"],
            "path_image_list": os.path.join(out_abs, "imagelist.txt"),
            "path_pairlist_training": os.path.join(out_abs, "pairlist_stereo.txt"),
            "path_pairlist_validation": os.path.join(out_abs, "pairlist_stereo.txt"),
            "area_type": "train+val",
            "allocation_strategy": "5-crossval_vertical",
            "test_stripe": 1,
            "n_training_samples": 512,
        }],
        "model": {"input_channels": "geom-stereo", "depth": 5},
        "stereopair_settings": {"use_all_stereo_pairs": True,
                                "permute_images_within_pair": False},
        "training_settings": {"tile_size": 128, "batch_size": 8, "n_epochs": 20,
                              "augment": True, "loss": "L1"},
        "optimizer": {"name": "Adam", "learning_rate": 0.0002},
        "scheduler": {"enabled": True, "name": "StepLR",
                      "settings": {"step_size": 10}},
        "general": {"save_model_rate": 10, "evaluate_rate": 1, "random_seed": 0},
        # balanced16 training: a bf16 activation trunk with the first and
        # last convs at 3 bf16 passes (K3 on the card); steps_per_call only
        # groups the batch order on one GPU. Speeds and accuracy: PERF.md.
        "tpu": {"train_precision": "balanced16", "steps_per_call": 8},
        "output": {"output_directory": os.path.join(out_abs, "runs"),
                   "suffix": "demo"},
    }
    with open(os.path.join(out_dir, "config_train.json"), "w") as f:
        json.dump(train_cfg, f, indent=2)

    test_cfg = {
        "datasets": [{
            "name": "demo_city",
            "raster_gt": absolute["gt"],
            "raster_in": absolute["dsm"],
            "path_image_list": os.path.join(out_abs, "imagelist.txt"),
            "path_pairlist": os.path.join(out_abs, "pairlist_test.txt"),
            "mask_building": absolute["building"],
            "mask_water": absolute["water"],
            "allocation_strategy": "5-crossval_vertical",
            "test_stripe": 1,
            "area_type": "test",
        }],
        "model": {
            "weights": "EDIT: <run_dir>/checkpoints/Model_best.npz",
            "architecture": "EDIT: <run_dir>/model_config.json",
            "normalization_geom": "EDIT: <run_dir>/DSM_normalization_parameters.p",
            "normalization_image": "EDIT: <run_dir>/Image_normalization_parameters.p",
        },
        # 'balanced16' serving: a bf16 trunk with the first and last convs
        # at 3 bf16 passes, within the 1 cm mean-deviation budget (PERF.md).
        # Remove the key for IEEE float32 serving.
        "general": {"tile_size": 128, "compute_dtype": "balanced16"},
        "output": {"directory": os.path.join(out_abs, "eval")},
    }
    with open(os.path.join(out_dir, "config_test.json"), "w") as f:
        json.dump(test_cfg, f, indent=2)

    print(f"Demo scene written to {out_abs}")
    print("Train:  python -m resdepth_tpu_torch.train "
          f"{os.path.join(out_abs, 'config_train.json')}")
    print("Then edit the four EDIT: paths in config_test.json to the run dir and:")
    print("Test:   python -m resdepth_tpu_torch.predict "
          f"{os.path.join(out_abs, 'config_test.json')}")


if __name__ == "__main__":
    main()
