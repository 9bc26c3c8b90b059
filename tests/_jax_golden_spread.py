"""The golden pipeline at several ``random_seed``s through the JAX
package's CLIs, the reference arm of
``resdepth_tpu_torch/studies/golden_spread.py`` (a test helper: the port
never starts the JAX package).

    python tests/_jax_golden_spread.py --out spread_jax.json [--seeds 0 1 2 3 4]

The same steps as the port's study (``golden_spread.run_seed``) through
``train.py`` and ``test.py`` in child processes on the XLA host platform
with 8 virtual devices (``scripts/make_demo_goldens.py::hermetic_env``), as it made the
committed goldens. Seed 0 is the committed golden run. On the CPU the 5
seeds take about 5 minutes.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from resdepth_tpu_torch.studies import golden_spread  # noqa: E402

JAX_DEVICES = 8


def jax_commands() -> tuple:
    """(train argv, inference argv, env) of ``train.py`` and ``test.py``
    on the CPU with ``JAX_DEVICES`` virtual devices, in
    ``make_demo_goldens.py``'s environment."""
    from resdepth_tpu.utils.hermetic import host_cpu_env

    env = {**host_cpu_env(JAX_DEVICES), "PYTHONPATH": REPO}
    return ([sys.executable, os.path.join(REPO, "train.py"), "{config}"],
            [sys.executable, os.path.join(REPO, "test.py"), "{config}"], env)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="JSON file of the results")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args(argv)
    result = {"seeds": args.seeds,
              **golden_spread.spread(args.seeds, "jax", commands=jax_commands())}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
