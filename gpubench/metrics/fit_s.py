"""Seconds a fit: the window up to the end of its last fit over the
fits it completed (host clock, after the device synchronized)."""


def read(sources):
    return sources.get("fit_s")
