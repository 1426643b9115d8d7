"""Device operations per traced session frame (profiler count)."""


def read(rec):
    traces = rec.get("traces")
    if not traces or "latency_ms" not in rec:
        return None
    n = traces[0].kernel_count()
    return n / rec["traced_frames"] if n else None
