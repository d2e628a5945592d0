"""``peak_mem_gib.<kind>``: the allocator's peak over the window (reset
at its start; the cache it serves from included), in GiB."""


def read(record, metric):
    peak = record.get("peak_window_bytes")
    return None if not peak else peak / 2**30
