#!/usr/bin/env bash
# The final card run of the ring bodies at padded head widths 128 and 256:
# chip_smoke.py from a checkout of the commit (FINAL, unpacked from
# git archive), the card tests, then tools/ab_paths PARENT FINAL (the
# attention kernels' bits and times in turns, the SASS of every entry
# both checkouts have, and the 192 px, --dtype mixed, 448 px and 2 x 256
# head steps in turns). From the repository's root:
#   bash torch_artifacts/ring_wide/run_final.sh OUT PARENT FINAL
OUT=$(realpath -m "${1:-build/ring_wide_final}")
PARENT=${2:-build/parent}
FINAL=${3:-build/final}
ROOT=$(pwd)
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader \
    | tee "$OUT/card.txt"
t0=$(date +%s)
cd "$FINAL" || exit 2
python3 chip_smoke.py > "$OUT/smoke.out" 2> "$OUT/smoke.err"
echo smoke rc=$? $(( $(date +%s) - t0 ))s
tail -n 2 "$OUT/smoke.out" | cut -c1-400
python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q \
    > "$OUT/gpu_tests.txt" 2>&1
echo tests rc=$? $(( $(date +%s) - t0 ))s
tail -n 3 "$OUT/gpu_tests.txt"
cd "$ROOT" || exit 2
python -m hgr_tpu_torch.tools.ab_paths "$PARENT" "$FINAL" > "$OUT/ab.jsonl" \
    2> "$OUT/ab.err"
echo ab rc=$? $(( $(date +%s) - t0 ))s
tail -c 600 "$OUT/ab.err"
tail -c 1500 "$OUT/smoke.err"
