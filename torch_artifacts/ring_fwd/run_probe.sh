#!/usr/bin/env bash
# The bf16 forward's ring body at head widths 16 and 64 on the card: the
# ring entries' ptxas lines, the forward's route sweep at 16 x 16 and
# 4 x 64, the C2 rows at N = 785 (probe.py), the ring constants' grids at
# (64, 785) and (16, 785) (tools/tune_attention), a parent checkout's
# kernels against this one's in turns with their bits and SASS
# (tools/ab_paths --bits-only; unpack the parent first:
# git archive <commit> | tar -x -C build/parent), and the card tests of
# the ring and the routes. From the repository's root:
#   bash torch_artifacts/ring_fwd/run_probe.sh [OUT]
OUT=${1:-build/ring_fwd}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader \
    | tee "$OUT/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python torch_artifacts/ring_fwd/probe.py > "$OUT/probe.jsonl"
echo probe rc=$? $(( $(date +%s) - t0 ))s
python -m hgr_tpu_torch.tools.tune_attention --n 785 --batch 64 16 \
    --heads 16 --head_dim 16 --grid ring16 > "$OUT/tune16.jsonl"
echo tune16 rc=$? $(( $(date +%s) - t0 ))s
python -m hgr_tpu_torch.tools.tune_attention --n 785 --batch 64 16 \
    --heads 4 --head_dim 64 --grid ring64 > "$OUT/tune64.jsonl"
echo tune64 rc=$? $(( $(date +%s) - t0 ))s
python -m hgr_tpu_torch.tools.ab_paths build/parent . --bits-only \
    > "$OUT/ab_bits.jsonl"
echo ab rc=$? $(( $(date +%s) - t0 ))s
python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q -x \
    -k "ring or forward_body or split_equals_packed or routes_give or every_length" \
    > "$OUT/gpu_tests.txt" 2>&1
echo tests rc=$? $(( $(date +%s) - t0 ))s
tail -n 3 "$OUT/gpu_tests.txt"
