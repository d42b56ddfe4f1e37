"""Share (%) of the device's busy time in the scatter kernels of Xᵀr
(PyTorch's ``index_add_``, whose kernels the profiler names
``indexFunc…``), from the profiler's device events."""

SCATTER = "indexFunc"


def read(sources):
    trace = sources.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    scatter = sum(s for name, s in trace["by_name"].items()
                  if SCATTER in name)
    return 100.0 * scatter / trace["busy_s"] if scatter > 0 else None
