"""Weight-EMA A/B on the convergence-study protocol (the port's copy of
``scripts/ema_study.py``).

    python -m resdepth_tpu_torch.studies.ema_study --conv-dir DIR
        [--seeds 0 1 2] [--decay 0.999] [--epochs 300]
        [--precision balanced16] [--samples N] [--device cuda]

``training_settings.ema_decay`` serves an exponential moving average of the
weights instead of the raw Adam iterate. This study reruns the toy
convergence protocol (``studies/convergence_study.py``: scene, allocation,
hyperparameters, seeds and metric as there; ``DIR`` is its ``gen``
directory) with the EMA on, through ``run_port(extra_training=
{"ema_decay": decay})``, and writes ``DIR/results/port_<tag>.json`` (tag
``seed<S>_steplr_<precision>_ema<digits>``, the JAX arm's keys and
``ema_decay``). It prints each seed's best val and refined test-stripe MAE
beside the port's EMA-off run in ``DIR`` (where ``convergence_study port``
wrote one), the JAX package's EMA and EMA-off runs on its TPU
(``docs/studies/ema/``, ``docs/studies/convergence/``) and the reference
torch stack's score.

On the CPU: ``--device cpu --epochs 2 --samples 40`` on a ``gen``
directory.
"""

from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ANCHORS = os.path.join(REPO, "docs", "studies")


def _stored(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> list:
    from resdepth_tpu_torch.studies import convergence_study as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--conv-dir", required=True,
                    help="a studies/convergence_study.py gen directory (toy protocol)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--decay", type=float, default=0.999)
    ap.add_argument("--epochs", type=int, default=cs.N_EPOCHS)
    ap.add_argument("--precision", default="balanced16",
                    choices=["balanced16", "high", "default", "balanced"])
    ap.add_argument("--samples", type=int, default=None, help="samples an epoch")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    decay_tag = str(args.decay).replace("0.", "")
    results = []
    for seed in args.seeds:
        tag = f"seed{seed}_steplr_{args.precision}_ema{decay_tag}"
        result = cs.run_port(args.conv_dir, cs.TOY, seed=seed, epochs=args.epochs,
                             scheduler="steplr", precision=args.precision,
                             device=args.device, tag=tag, n_samples=args.samples,
                             extra_training={"ema_decay": args.decay})
        result["ema_decay"] = args.decay
        with open(os.path.join(args.conv_dir, "results", f"port_{tag}.json"), "w") as f:
            json.dump(result, f, indent=1)
        results.append(result)

    nan = float("nan")
    print(f"\nEMA A/B (decay {args.decay}, {args.epochs} epochs, {args.precision}); "
          "JAX columns: the JAX package on its TPU")
    print(f"{'seed':>5s} {'best_val(ema)':>14s} {'best_val(off)':>14s} {'test(ema)':>10s} "
          f"{'test(off)':>10s} {'JAX test(ema)':>14s} {'JAX test(off)':>14s} "
          f"{'test(torch)':>12s}")
    for seed, result in zip(args.seeds, results):
        off = _stored(os.path.join(args.conv_dir, "results",
                                   f"port_seed{seed}_steplr_{args.precision}.json")) or {}
        jax_ema = _stored(os.path.join(
            ANCHORS, "ema", f"jax_seed{seed}_steplr_{args.precision}_ema{decay_tag}.json")) or {}
        jax_off = _stored(os.path.join(
            ANCHORS, "convergence", f"jax_seed{seed}_steplr_{args.precision}.json")) or {}
        torch_ref = _stored(os.path.join(ANCHORS, "convergence",
                                         f"torch_seed{seed}_steplr.json")) or {}
        print(f"{seed:5d} {result['best_val_mae']:14.4f} "
              f"{off.get('best_val_mae', nan):14.4f} {result['refined_test_mae']:10.4f} "
              f"{off.get('refined_test_mae', nan):10.4f} "
              f"{jax_ema.get('refined_test_mae', nan):14.4f} "
              f"{jax_off.get('refined_test_mae', nan):14.4f} "
              f"{torch_ref.get('refined_test_mae', nan):12.4f}")
    return results


if __name__ == "__main__":
    main()
