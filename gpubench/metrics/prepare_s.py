"""Seconds of the estimator's preparation in set-up (host ETL, layout
builds and placement), on the benchmark's clock around the seams."""


def read(sources):
    return sources.get("prepare_s")
