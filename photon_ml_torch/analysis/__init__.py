"""Runtime guards (``analysis.guards``)."""
