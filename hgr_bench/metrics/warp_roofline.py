"""``warp_roofline.<kind>``: the warp kernel's least time over its device
time in the traced slice, as a share (%): each traced step's launch
bound by ``counts.warp`` (its canvases' footprints under the step's
drawn affines, read once; the uint8 crop written once; float32
operations on the CUDA cores), against the trace's
``warp_twopass_kernel`` time."""

from hgr_bench import counts
from hgr_bench.trace import kernel_seconds


def read(record, metric):
    tr = record.get("trace")
    bounds = record.get("warp_bounds")
    if tr is None or not bounds:
        return None
    secs = kernel_seconds(tr, "warp_twopass")
    if secs <= 0:
        return None
    bound = sum(counts.bound_s(b, f, counts.PEAK_F32_FLOPS)
                for b, f in bounds)
    return 100.0 * bound / secs
