"""Share of the traced session frames' wall time in which nothing ran on
the device, in percent (an upper bound, as the profiler stretches it)."""


def read(rec):
    traces = rec.get("traces")
    if not traces or "latency_ms" not in rec:
        return None
    busy = traces[0].busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / traces[0].wall_s)
