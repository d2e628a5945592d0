"""``attention_roofline.<kind>``: the attention kernels' least time over
their device time in the traced slice, as a share (%). The least time
sums each launch's bound (``counts.attention_fwd`` / ``attention_bwd``
at the launch's shape); the launches are the package's counters over
the slice, the time the trace's ``attention_*`` / ``wide_*`` kernels.
A train slice counts forward and backward launches; a served slice the
forwards, at the batch sizes its micro-batcher ran (its bucket
histogram over the slice)."""

from hgr_bench import counts
from hgr_bench.trace import kernel_seconds


def read(record, metric):
    tr = record.get("trace")
    shape = record.get("attention_shape")
    if tr is None or shape is None:
        return None
    b, n, heads, head_dim = shape
    if "launches" in record:  # a train slice: (fwd, bwd, warp) launches
        fwd, bwd, _ = record["launches"]
        bound = (fwd * counts.bound_s(*counts.attention_fwd(b, n, heads,
                                                            head_dim))
                 + bwd * counts.bound_s(*counts.attention_bwd(b, n, heads,
                                                              head_dim)))
        secs = kernel_seconds(tr, "attention_fwd", "attention_bwd",
                              "wide_fwd", "wide_bwd")
    else:
        m0, m1 = record["serve_traced"]
        hist = {int(k): v - m0["batch_hist"].get(k, 0)
                for k, v in m1["batch_hist"].items()}
        batches = sum(hist.values())
        launches = record.get("attention_fwd_launches", 0)
        if batches <= 0 or launches <= 0:
            return None
        per_batch = launches / batches
        bound = sum(cnt * per_batch * counts.bound_s(*counts.attention_fwd(
            bb, n, heads, head_dim)) for bb, cnt in hist.items())
        secs = kernel_seconds(tr, "attention_fwd", "wide_fwd")
    if secs <= 0 or bound <= 0:
        return None
    return 100.0 * bound / secs
