#!/usr/bin/env bash
# The ring bodies at padded head widths 128 and 256 on the card: every
# ring entry's ptxas line, the forward's route sweep at 2 x 128 and the C2
# rows at widths 128, 192 and 256 (probe.py), the ring constants' grids
# at (16, 785) (tools/tune_attention --grid ring128 / ring256), a parent
# checkout's kernels against this one's in turns with their bits and SASS
# (tools/ab_paths --bits-only; unpack the parent first:
# git archive <commit> | tar -x -C build/parent), and the card tests of
# the ring bodies and the routes. From the repository's root:
#   bash torch_artifacts/ring_wide/run_probe.sh [OUT]
OUT=${1:-build/ring_wide}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader \
    | tee "$OUT/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python torch_artifacts/ring_wide/probe.py > "$OUT/probe.jsonl" 2> "$OUT/probe.err"
echo probe rc=$? $(( $(date +%s) - t0 ))s
for dp in 256 128; do
    python -m hgr_tpu_torch.tools.tune_attention --n 785 --batch 16 \
        --heads 2 --head_dim $dp --grid ring$dp > "$OUT/tune$dp.jsonl" \
        2> "$OUT/tune$dp.err"
    echo tune$dp rc=$? $(( $(date +%s) - t0 ))s
done
python -m hgr_tpu_torch.tools.ab_paths build/parent . --bits-only \
    > "$OUT/ab_bits.jsonl" 2> "$OUT/ab_bits.err"
echo ab rc=$? $(( $(date +%s) - t0 ))s
python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q \
    -k "ring or body or split_equals_packed or routes_give or any_length" \
    > "$OUT/gpu_tests.txt" 2>&1
echo tests rc=$? $(( $(date +%s) - t0 ))s
tail -n 5 "$OUT/gpu_tests.txt"
grep -h "CHECK FAILED" "$OUT/probe.jsonl" | cut -c1-600 | head -n 8
tail -n 1 "$OUT/probe.jsonl" | cut -c1-1500
tail -c 1500 "$OUT/probe.err"
