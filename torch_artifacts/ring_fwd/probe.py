"""chip_smoke's build, route and C2 phases for the bf16 forward's ring body
at head widths 16 and 64, alone: the ring entries' ptxas lines, the
route sweep's rows at 16 heads of 16 and 4 of 64, and the C2 rows at
N = 785 of head widths 16, 64, 128 and 256 (body, SDPA, bound, SFU
floor). Failed checks are printed and listed in the last line, not
raised, so that every phase reports. Run from the repository's root on a
machine with the card (torch_artifacts/ring_fwd/run_probe.sh)."""
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
                      if r[0] == "fwd" and r[5] != 32]
    guarded(cs.route_phase, torch)
    cs.C2_SHAPES = [s for s in cs.C2_SHAPES if s[1] == 785
                    and s[4] == "bfloat16" and s[3] in (16, 64, 128, 256)]
    cs.C2_WIDE_CHECKS = []
    guarded(cs.c2_kernel_phase, torch)
    print(json.dumps({"failed": failed}), flush=True)


if __name__ == "__main__":
    main()
