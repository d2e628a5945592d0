#!/usr/bin/env bash
# tools/bn_convergence_ab's f32-BN arm (its fixture: 4,096 / 512 / 512
# synthetic images; 60 epochs at B = 256, lr 1e-3, bf16 compute) at
# seeds 7 and 123, with the fused BN backward off and on: the tool's own
# training-CLI command with --seed changed (the tool fixes seed 42). The
# four runs share the card at once (their F1s are the result; no time
# of theirs is read). Needs the card. From the repository root:
#
#   bash torch_artifacts/bn_convergence_seeds/run.sh [OUT] [WORK]
#
# OUT (default torch_artifacts/bn_convergence_seeds) receives
# s{SEED}_fused_{off,on}.metrics.jsonl and .log, and card.txt.
set -euo pipefail
out=${1:-torch_artifacts/bn_convergence_seeds}
work=${2:-build/bn_convergence_seeds}
mkdir -p "$out" "$work"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/card.txt"
python -c "import sys; from hgr_tpu_torch.tools.headtohead import \
build_fixture; build_fixture(sys.argv[1], 4096, 512, 512)" "$work/data"
unset HGR_TPU_BN_DTYPE
pids=()
for seed in 7 123; do
    for fused in off on; do
        name=s${seed}_fused_$fused
        rm -rf "${work:?}/out_$name" "${work:?}/logs_$name"
        HGR_TPU_FUSED_BN=$fused python -m hgr_tpu_torch.cli.train \
            --data_config "$work/data/data.yaml" --suffix bnab_f32 \
            --batch_size 256 --epochs 60 --lr 0.001 --lr_step 50 \
            --seed "$seed" --dtype bfloat16 \
            --log_dir "$work/logs_$name" --save_dir "$work/out_$name" \
            --num_workers 8 --image_size 192 192 --device cuda \
            > "$out/$name.log" 2>&1 &
        pids+=($!)
    done
done
status=0
for pid in "${pids[@]}"; do wait "$pid" || status=1; done
for seed in 7 123; do
    for fused in off on; do
        name=s${seed}_fused_$fused
        cp "$work/logs_$name/gelans_192x192_bnab_f32/metrics.jsonl" \
            "$out/$name.metrics.jsonl" || status=1
    done
done
exit $status
