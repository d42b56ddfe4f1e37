"""One module a timed entry into the port, found by the traffic's
``entry`` name.

Each module defines:

- ``Entry(port, data, config, traffic, device)``, whose construction is
  the cell's preparation (timed as ``prepare_s``).  An ``Entry`` has
  ``fit(record)``, one timed fit from the same starting coefficients
  returning {leaf name: [device tensors]}; ``keep(leaves)`` and
  ``host(kept)``, what judges a fit, copied on the device and read back
  once the window has closed; and ``release()``, which drops the port's
  state before the reference runs.
- ``reference_answer(data, config, traffic, dtype, device,
  weights=None)``: the plain reference's answer (``dtype`` float64; a
  lower precision for the control; row ``weights`` for a planted fault).
- ``leaf_lambdas(traffic)``: each leaf's λ.
- ``numbers(answers, data, config, traffic, device, reference=None)``
  → ({number: reading} an answer, the float64 reference).
- ``judge(kept, data, config, traffic, device)`` → {window index:
  {number: reading}} of the kept fits (``kept``: window index →
  answer).
- ``window`` (optional): the measured window, in place of
  ``gpubench.run.repeat_fits`` and called as it is (``entry, seconds,
  trace, device, inst, pick, port``).
"""

from __future__ import annotations

import importlib


def load(name: str):
    """The entry module ``gpubench/entries/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"bad entry name {name!r}")
    return importlib.import_module(f"gpubench.entries.{name}")
