"""Loop drivers: ``<name>.py`` defines ``Driver``, found by the ``driver``
a traffic mix names. A driver takes ``(config, traffic, recordings,
device)``, mines each array's first windows in ``warm``, runs the closed
loop until the deadline in ``run`` (calling ``after_window`` whenever no
lane is mining), lets what was submitted finish in ``finish``, counts
the windows handed over in ``submitted()``, and keeps every returned
window's ``MiningResult`` in ``results[array][window]`` and every window
returned inside the measured loop in ``done``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Done:
    """One window's delta back from the program."""

    array: int
    window: int
    n_events: int
    submitted: float  # host clock when the window was handed over
    returned: float   # host clock when its delta was back


class RanOut(RuntimeError):
    """An array reached the end of its recording inside the run."""
