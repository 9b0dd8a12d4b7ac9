"""The serving loop's straggler watchdog (the port's copy of
``repro.runtime.fault_tolerance.StragglerWatchdog``).

The server feeds it the wall time of every dispatched batch, taken after the
batch's results reached the host, and counts the batches it flags.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor: flags steps slower than `threshold`x the mean.

    The flag is recorded for the metrics log (``SearchServer.n_stragglers``)
    and asserted on in tests.
    """
    alpha: float = 0.1
    threshold: float = 3.0
    ewma: float | None = None
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.flagged.append((step, dt))
        return slow
