#!/usr/bin/env bash
# The port's trainer under recipe B (the training CLI's defaults: bf16,
# de-mixed pullbacks) at the seven seeds whose reference and JAX-package
# finals are committed, each through tools/headtohead with the seed's
# committed reference curve, then tools/h2h_stats over the seven runs;
# then the JAX package's first bisection arm, seed 42 with f32 compute
# (its committed counterpart: bench_artifacts/headtohead_r4/
# ours_f32_seed42.jsonl). Needs the card. From the repository root:
#
#   bash torch_artifacts/headtohead/run.sh [OUT] [WORK]
#
# OUT (default torch_artifacts/headtohead) receives per seed
# s{SEED}/ours_logs/gelans_192x192_h2h/metrics.jsonl,
# s{SEED}/headtohead_summary.json and s{SEED}.log, the f32 arm as
# f32_s42/..., h2h_stats.json and card.txt; WORK (default build/h2h)
# keeps the fixtures and checkpoints.
set -euo pipefail
out=${1:-torch_artifacts/headtohead}
work=${2:-build/h2h}
run=ours_logs/gelans_192x192_h2h
recipe=(--epochs 50 --lr 1e-3 --lr_step 30 40 --lr_factor 0.1
        --batch_size 32 --sigma 2 --train_n 380 --val_n 190 --test_n 380)
mkdir -p "$out" "$work"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/card.txt"

one() {  # name seed [extra flags...]
    local name=$1 seed=$2 ref=""
    shift 2
    for f in bench_artifacts/headtohead_r4/reference_seed"$seed".jsonl \
             bench_artifacts/headtohead_r5/reference_seed"$seed".jsonl \
             bench_artifacts/headtohead_r3/recipeB/reference_seed"$seed".jsonl
    do
        if [ -f "$f" ]; then ref=$f; fi
    done
    rm -rf "${work:?}/$name"
    python -m hgr_tpu_torch.tools.headtohead --workdir "$work/$name" \
        --seed "$seed" "${recipe[@]}" "$@" \
        ${ref:+--reference_metrics "$ref"} > "$out/$name.log" 2>&1
    mkdir -p "$out/$name/$run"
    cp "$work/$name/$run/metrics.jsonl" "$out/$name/$run/"
    cp "$work/$name/headtohead_summary.json" "$out/$name/"
}

status=0
for seed in 7 42 43 123 256 999 1337; do
    one "s$seed" "$seed" || status=1
done
python -m hgr_tpu_torch.tools.h2h_stats --r5_glob "$out/s*" \
    --out "$out/h2h_stats.json" || status=1
one f32_s42 42 --ours_dtype float32 || status=1
exit $status
