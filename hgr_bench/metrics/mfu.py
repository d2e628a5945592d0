"""``mfu.<kind>``: the model FLOPs of the work the window completed
outside its traced slice (which the profiler slows), per second of the
window outside it, as a share (%) of the card's bf16 peak. A train step
counts 3 forwards' FLOPs a crop (the forward and a backward of twice
its work; the second de-mixed pullback is the package's choice, not
model work), a served crop or frame one forward (a frame: the
detector's and the classifier's)."""

from hgr_bench.counts import PEAK_BF16_FLOPS


def read(record, metric):
    if "outside_trace" not in record or "forward_flops" not in record:
        return None
    items, seconds = record["outside_trace"]
    if items <= 0 or seconds <= 0:
        return None
    flops = record["flops_per_item"] * record["forward_flops"] * items
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
