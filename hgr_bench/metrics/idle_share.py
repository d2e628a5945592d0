"""``idle_share.<kind>``: 1 - busy / window over the traced slice (busy:
the union of the device events' intervals), as a share (%)."""


def read(record, metric):
    tr = record.get("trace")
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
