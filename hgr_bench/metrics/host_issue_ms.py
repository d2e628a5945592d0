"""``host_issue_ms.<kind>``: the median host time, in ms, to issue one
train step: the benchmark's span around each ``step_fn`` call that
``train_epoch`` makes in the window (no synchronize inside it; the
launch queue's back-pressure shows as issue time once the host runs
ahead of the card)."""

import statistics


def read(record, metric):
    spans = record.get("host_issue_s")
    if not spans:
        return None
    return statistics.median(spans) * 1e3
