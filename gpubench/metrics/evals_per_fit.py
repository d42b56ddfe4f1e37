"""Objective evaluations a fit (value-and-gradient and value-only calls
at the objective's boundary)."""


def read(sources):
    fits = [f for f in sources.get("fits", [])
            if f["evaluations"] is not None]
    if not fits:
        return None
    return sum(f["evaluations"] for f in fits) / len(fits)
