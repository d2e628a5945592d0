"""Run one cell of the benchmark once, on the card of this machine:

    python3 -m hgr_bench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the numbers that
decide ``correct`` are also the last lines of standard error, each
beside its limit. Without a CUDA card, or with fewer cards than the cell
asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def process_start() -> float:
    """The process's start on ``time.monotonic``'s clock, from
    /proc/self/stat (this module's import where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return STARTED


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    import torch

    from hgr_bench import harness

    bench = harness.benchmark()
    work, config, traffic = harness.cell(bench, args.workload)
    chips = int(work["chips"])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"needs {chips} CUDA card(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    ctx = harness.Ctx(work, config, traffic, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), started)
    out = harness.driver(traffic)(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    line = harness.result_line(bench, ctx, out,
                               torch.cuda.get_device_name(0), chips)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
