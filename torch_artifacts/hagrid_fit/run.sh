#!/usr/bin/env bash
# The full HaGRID train split (410,800 rows, canvas 192: 42.42 GiB) as a
# device cache on one card: (a) tools/hagrid_fit --mode virtual, the
# JAX tool's experiment (8 shards built one after another); (b) --mode
# chip at the per-chip load of an 8-chip split; (c) --mode chip with
# the whole split beside the step, and the headroom probed; (d) one
# epoch of fit served from the whole train and val caches, fused BN off
# and on (epoch.py says how). Needs the card. From the repository root:
#
#   bash torch_artifacts/hagrid_fit/run.sh [OUT] [WORK]
#
# OUT (default torch_artifacts/hagrid_fit) receives card.txt,
# {virtual,chip8,chip1}.json with their .log, epoch.json, epoch.log and
# fused_{off,on}.metrics.jsonl; WORK (default build/hagrid_fit) the
# epoch's checkpoints. No cache is written to disk.
set -euo pipefail
out=${1:-torch_artifacts/hagrid_fit}
work=${2:-build/hagrid_fit}
mkdir -p "$out" "$work"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/card.txt"
# the step's kernels, one nvcc each, all at once, before the runs load them
python -c "from hgr_tpu_torch.utils.cuda_build import load_kernels; \
load_kernels(['attention_qkv_fwd', 'attention_qkv_bwd', 'warp_twopass', \
'bn_act_bwd'])"

status=0
one() {  # name [tool flags...]
    local name=$1
    shift
    python -m hgr_tpu_torch.tools.hagrid_fit "$@" --out "$out/$name.json" \
        > "$out/$name.log" 2>&1 || status=1
}
one virtual --mode virtual --n 410800 --devices 8 --batch 1024
one chip8 --mode chip --devices 8
one chip1 --mode chip --devices 1 --probe_headroom
python torch_artifacts/hagrid_fit/epoch.py --out "$out" --work "$work" \
    > "$out/epoch.log" 2>&1 || status=1
exit $status
