"""The whole fit's share (%) of the card's peak memory rate: the byte
bound of every evaluation the fits made (``port.evaluation_bytes``:
each array an evaluation reads, read once; its outputs written once)
over the fits' wall, on the fits the profiler did not slow.  Bytes-bound:
the fits' arithmetic is a few operations a byte."""


def read(sources):
    peak = sources.get("bytes_per_s")
    fits = [f for f in sources.get("fits", []) if f["span"] is None
            and f["eval_bytes"] is not None]
    wall = sum(f["end"] - f["start"] for f in fits)
    if not peak or not fits or wall <= 0:
        return None
    return 100.0 * sum(f["eval_bytes"] for f in fits) / peak / wall
