"""Seconds from the process's start to the first timed fit: start-up,
the inputs, the entry's preparation and the warm fit (host clock)."""


def read(sources):
    return sources.get("setup_s")
