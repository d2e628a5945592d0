#!/usr/bin/env bash
# The port's detector trainer at the JAX tool's recipe (800 steps on 250
# unique batches, B 16, 416 px, Adam 1e-3) at seeds 0-4 in two arms, the
# detect heads drawn as the JAX package draws them (repaired) and as the
# port drew them before (before), then the JAX tool's committed seed-0
# weights read through the port (fixture), then the decision rule over
# them (arm.py says what each arm and reading is). Needs the card. From
# the repository root:
#
#   bash torch_artifacts/detector_recipe/run.sh [OUT] [WORK]
#
# OUT (default torch_artifacts/detector_recipe) receives card.txt, per
# arm and seed {arm}_s{S}.log and {arm}_s{S}/summary.json, fixture_s0/
# summary.json and rule.json; WORK (default build/detector_recipe) the
# weights (.npz, 11 MB each). The five seeds of an arm run at once.
set -euo pipefail
out=${1:-torch_artifacts/detector_recipe}
work=${2:-build/detector_recipe}
arm=torch_artifacts/detector_recipe/arm.py
mkdir -p "$out" "$work"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/card.txt"
# the pipeline's attention kernel, built once before the arms load it
python -c "from hgr_tpu_torch.utils.cuda_build import load_kernel; \
load_kernel('attention_qkv_fwd')"

status=0
for name in repaired before; do
    pids=()
    for seed in 0 1 2 3 4; do
        if [ "$name" = repaired ]; then npz="$work/s$seed.npz"
        else npz="$work/before_s$seed.npz"; fi
        python "$arm" "$name" --seed "$seed" --npz "$npz" --out "$out" \
            > "$out/${name}_s$seed.log" 2>&1 &
        pids+=($!)
    done
    for pid in "${pids[@]}"; do wait "$pid" || status=1; done
done
python "$arm" fixture --out "$out" > "$out/fixture_s0.log" 2>&1 || status=1
python "$arm" rule --out "$out" || status=1
exit $status
