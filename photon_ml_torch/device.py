"""The one place an entry point turns a ``device`` argument into a
``torch.device``.

The port runs on the GPU.  The CPU is taken only when the caller asks
for it by name (the tests do); a request for CUDA on a machine without
it raises instead of quietly running somewhere else.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → ``cpu``; anything naming CUDA
    must find CUDA available, else ``RuntimeError``."""
    try:
        dev = torch.device("cuda" if device is None else device)
    except RuntimeError as e:    # a string torch does not parse
        raise ValueError(f"unsupported device {device!r}: use 'cuda' "
                         "(default) or 'cpu'") from e
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' "
                         "(default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
