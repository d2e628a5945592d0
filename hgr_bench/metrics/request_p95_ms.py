"""``request_p95_ms.<kind>``: the 95th percentile, over every request
resolved in the window, of the client-side time from submit to the
resolved future (a failed request counts as missing). A closed loop
keeps the batcher full, so the tail follows the rate and swings with
the host: a per-layer reading beside the cell's rate, not a bound."""


def read(record, metric):
    return record.get("p95_ms")
