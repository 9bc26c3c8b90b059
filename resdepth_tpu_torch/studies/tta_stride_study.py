"""Joint TTA x tile-stride grid: accuracy and cost of each cell (the port's
copy of ``scripts/tta_stride_study.py``).

    python -m resdepth_tpu_torch.studies.tta_stride_study --state-cache S.npz
        [--device cuda] [--rows 2048] [--cols 2048] [--scene-seed 3]
        [--mode balanced16] [--strides 128 192] [--ttas 1 4 8]
        [--merge mean|median] [--stitch k2|k1] [--tile 256] [--depth 5]
        [--start-kernel 64] [--json OUT.json]

Every (stride, tta) cell refines the same seeded city with the state
cache's model (``studies/precision_study.py --state-cache``; see
``studies/stride_study.py``): ``predict_linear_blend`` with
``general.tile_stride`` and ``general.tta``, K2 (or K1) stitching on the
card. Each cell reports the refined MAE against the ground truth, the
scene's seconds with rasters resident (CUDA events on the card, best of 3
after a warm-up; host clock on the CPU) and the model passes relative to
the parity cell (stride tile/2, tta 1), or to the cheapest cell measured
when the grid leaves that out (and says so).

On the CPU, from the smoke model's cache: ``--device cpu --tile 32
--depth 2 --start-kernel 4 --rows 128 --cols 128 --strides 16 24``.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np


def main(argv=None) -> dict:
    from resdepth_tpu_torch.data.pipeline import device_put_dataset
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend
    from resdepth_tpu_torch.studies import stride_study as ss
    from resdepth_tpu_torch.studies.precision_study import device_name, make_city

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ss.add_common_arguments(ap)
    ap.add_argument("--strides", type=int, nargs="+", default=None,
                    help="default: tile/2 and 3*tile/4")
    ap.add_argument("--ttas", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--merge", default="mean", choices=["mean", "median"])
    args = ap.parse_args(argv)
    strides = args.strides or [args.tile // 2, 3 * args.tile // 4]
    device, dtype, use_pallas, served = ss.setup(args)
    clock = ss.time_key(device)

    cells = {}
    with tempfile.TemporaryDirectory(prefix="tta_stride_") as work:
        city = make_city(work, args.rows, args.cols, args.scene_seed)
        gt = city["gt"]
        valid = gt != -9999.0
        mae_in = float(np.abs(city["dsm_in"] - gt)[valid].mean())
        for stride in strides:
            ds = ss.test_dataset(city, args.tile, stride)
            rasters = device_put_dataset(ds, device)
            for tta in args.ttas:
                def run():
                    return predict_linear_blend(
                        served, ds, device=device, batch_size=args.batch_size,
                        compute_dtype=dtype, rasters=rasters, use_pallas=use_pallas,
                        fold_bn=False, as_numpy=False, tta=tta, tta_merge=args.merge)

                pred, seconds = ss.scene_seconds(run, device)
                mae = float(np.abs(pred.cpu().numpy() - gt)[valid].mean())
                cells[(stride, tta)] = {"stride": stride, "tta": tta, "tiles": len(ds),
                                        "model_passes": len(ds) * tta, clock: seconds,
                                        "mae_m": mae}
                print(f"[stride {stride:3d} tta {tta}] {len(ds):4d} tiles x {tta} "
                      f"passes, {clock} {seconds:8.4f} s/scene, MAE {mae:.4f} m",
                      flush=True)
            del rasters

    parity = (args.tile // 2, 1)
    base_key = parity if parity in cells else (min(strides), min(args.ttas))
    base = cells[base_key]
    print(f"\nscene {args.rows}x{args.cols}, mode {args.mode}, merge {args.merge}, "
          f"{device_name(device)}; input MAE {mae_in:.3f} m; rel-compute/rel-time base "
          f"cell = stride {base_key[0]}, tta {base_key[1]}"
          + ("" if base_key == parity else
             f" (NOT the stride-{parity[0]}/tta-1 parity point — it was not in this grid)"))
    print(f"{'stride':>6s} {'tta':>4s} {'passes':>7s} {'rel compute':>12s} "
          f"{clock:>9s} {'rel time':>9s} {'MAE(m)':>8s} {'dMAE(cm)':>9s}")
    for (stride, tta), c in sorted(cells.items()):
        c["rel_compute"] = c["model_passes"] / base["model_passes"]
        print(f"{stride:6d} {tta:4d} {c['model_passes']:7d} {c['rel_compute']:11.2f}x "
              f"{c[clock]:9.4f} {c[clock] / base[clock]:8.2f}x "
              f"{c['mae_m']:8.4f} {(c['mae_m'] - base['mae_m']) * 100:+9.3f}")
    out = {"device": device_name(device), "mode": args.mode, "merge": args.merge,
           "stitch": args.stitch, "rows": args.rows, "cols": args.cols,
           "input_mae": mae_in, "base_cell": list(base_key),
           "cells": list(cells.values())}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"\ncells -> {args.json}")
    return out


if __name__ == "__main__":
    main()
