#!/usr/bin/env bash
# End-to-end demo on the port: synthesize a scene, train briefly, run tiled
# inference and evaluation against the generated ground truth and masks
# (the port's copy of scripts/run_demo.sh).
#
# Usage: resdepth_tpu_torch/run_demo.sh [demo_dir] [--cpu]
#   runs on the GPU; --cpu passes --device cpu to both CLIs
set -euo pipefail
cd "$(dirname "$0")/.."

DEMO_DIR="demo"
DEVICE="cuda"
for arg in "$@"; do
  case "$arg" in
    --cpu) DEVICE="cpu" ;;
    *) DEMO_DIR="$arg" ;;
  esac
done

python -m resdepth_tpu_torch.make_demo_data "$DEMO_DIR"
python -m resdepth_tpu_torch.train "$DEMO_DIR/config_train.json" --device "$DEVICE"

RUN_DIR=$(ls -dt "$DEMO_DIR"/runs/*/ | head -1)
python - "$DEMO_DIR" "$RUN_DIR" <<'PY'
import json, sys, os
demo_dir, run_dir = sys.argv[1], sys.argv[2].rstrip("/")
cfg_path = os.path.join(demo_dir, "config_test.json")
cfg = json.load(open(cfg_path))
cfg["model"] = {
    "weights": os.path.join(run_dir, "checkpoints", "Model_best.npz"),
    "architecture": os.path.join(run_dir, "model_config.json"),
    "normalization_geom": os.path.join(run_dir, "DSM_normalization_parameters.p"),
    "normalization_image": os.path.join(run_dir, "Image_normalization_parameters.p"),
}
json.dump(cfg, open(cfg_path, "w"), indent=2)
print("wired inference config to", run_dir)
PY

python -m resdepth_tpu_torch.predict "$DEMO_DIR/config_test.json" --device "$DEVICE"
echo "Demo complete. Outputs in $DEMO_DIR/eval/"
