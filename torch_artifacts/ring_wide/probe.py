"""chip_smoke's build, route and C2 phases for the ring bodies at padded
head widths 128 and 256, alone: every ring entry's ptxas line (forward
and backward, each width), the route sweep's rows at 2 heads of 128, and
the C2 rows of head widths 128, 192 and 256 (bodies, SDPA, bound).
Failed checks are printed and listed in the last line, not raised, so
that every phase reports. Run from the repository's root on a machine
with the card (torch_artifacts/ring_wide/run_probe.sh)."""
import json
import os
import sys
import traceback

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

failed = []


def check(cond, what):
    if not cond:
        failed.append(what[:2000])
        print("CHECK FAILED", what[:2000], flush=True)


def guarded(fn, *args):
    try:
        fn(*args)
    except Exception:
        failed.append(traceback.format_exc()[-2000:])
        traceback.print_exc()


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.check = check
    print(cs.card_line(), flush=True)
    guarded(cs.build_phase)
    cs.ROUTE_SWEEP = [r for r in cs.ROUTE_SWEEP
                      if r[0] == "fwd" and r[5] == 128]
    guarded(cs.route_phase, torch)
    cs.C2_SHAPES = [s for s in cs.C2_SHAPES if s[4] == "bfloat16"
                    and s[3] in (128, 192, 256)]
    cs.C2_WIDE_CHECKS = [c for c in cs.C2_WIDE_CHECKS if c[2] == "bfloat16"]
    guarded(cs.c2_kernel_phase, torch)
    print(json.dumps({"failed": failed}), flush=True)


if __name__ == "__main__":
    main()
