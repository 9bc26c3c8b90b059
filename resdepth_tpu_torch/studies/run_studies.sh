#!/usr/bin/env bash
# Run the port's studies on the GPU at the sizes their docstrings name, and
# the demo flow; every result and log goes under OUT_DIR.
#
# Usage: resdepth_tpu_torch/studies/run_studies.sh OUT_DIR
#
# Order: the timed studies first, one at a time (the precision study's
# state cache, its --attrib, the stride, TTA and TTA x stride studies on
# that cache, the bilinear study, the train-step throughput matrix, the
# roofline with --measure); then, side by side, the toy convergence runs
# (seeds 0-2 EMA off and at decay 0.999), the config smoke (8 cases) and
# the demo flow with the golden pipeline, which only their accuracy
# measures; last the TTA study's mode A over the convergence runs. A study
# that fails is reported and the rest still run; the exit code is 1 if any
# failed. About 14 minutes on one H100.
set -uo pipefail
cd "$(dirname "$0")/../.."
OUT="${1:?usage: run_studies.sh OUT_DIR}"
mkdir -p "$OUT"
S="python -m resdepth_tpu_torch.studies"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
fail=0

# run LOG COMMAND...: the command's output to OUT/LOG, its time and status to stdout
run() {
  local log="$OUT/$1" start=$SECONDS
  shift
  if "$@" >> "$log" 2>&1; then
    echo "ok $(( SECONDS - start )) s: $*"
  else
    echo "FAILED $(( SECONDS - start )) s: $* (see $log)"
    fail=1
    return 1
  fi
}

CACHE="$OUT/study_state_s3.npz"
run precision.log $S.precision_study --seeds 3 --train-precision default \
    --state-cache "$CACHE" --out "$OUT/precision_s3.json"
run attrib.log $S.precision_study --seeds 3 --train-precision default \
    --state-cache "$CACHE" --attrib --out "$OUT/attrib_s3.json"
run stride.log $S.stride_study --state-cache "$CACHE" --json "$OUT/stride.json"
run tta_flagship.log $S.tta_study --state-cache "$CACHE" --json "$OUT/tta_flagship.json"
run tta_stride.log $S.tta_stride_study --state-cache "$CACHE" --json "$OUT/tta_stride.json"
run bilinear.log $S.bilinear_study --state-cache "$OUT/study_state_bilinear_s3.npz" \
    --json "$OUT/bilinear.json"
run throughput.log $S.train_throughput_study --modes high --batches 3,20,32 --remat both
run throughput.log $S.train_throughput_study --modes default,balanced,balanced16,bf16 \
    --batches 3,20,32
run roofline.log $S.train_roofline --modes balanced16,high --batches 20,32 --measure \
    --json "$OUT/roofline.json"

CONV="$OUT/conv"
run conv_gen.log $S.convergence_study gen --out "$CONV"
for seed in 0 1 2; do
  run "conv_seed$seed.log" $S.convergence_study port --out "$CONV" --seed "$seed" &
  run "ema_seed$seed.log" $S.ema_study --conv-dir "$CONV" --seeds "$seed" &
done
run config_smoke.log $S.config_smoke 0 8 --root "$OUT/config_smoke" &
( run demo.log resdepth_tpu_torch/run_demo.sh "$OUT/demo"; demo=$?
  run goldens.log python -m resdepth_tpu_torch.make_demo_goldens --out "$OUT/goldens" \
      && exit "$demo" ) &
for job in $(jobs -p); do wait "$job" || fail=1; done
run conv_report.log $S.convergence_study report --out "$CONV"
run tta_conv.log $S.tta_study --conv-dir "$CONV" --out "$OUT/tta_conv"
exit "$fail"
