"""``batch_fill.<kind>``: items over (batches x max_batch) that the
service's micro-batcher ran in the window, from the deltas of its
``ServeMetrics`` counters, as a share (%)."""


def read(record, metric):
    serve = record.get("serve")
    if serve is None:
        return None
    m0, m1 = serve
    batches = m1["batches"] - m0["batches"]
    if batches <= 0:
        return None
    items = m1["requests"] - m0["requests"]
    return 100.0 * items / (batches * record["max_batch"])
