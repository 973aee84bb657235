"""Console progress reporting.

Output contract (what the reference's bar renders, ref sdf/progress.py):
one line, rewritten in place via ``\r``, of the form

      42% (34 of 80) [############------------------] 0:00:12 0:00:17

i.e. percent, current/total values, a 30-cell bar, elapsed time and an
ETA extrapolated from the mean rate so far, each duration as h:mm:ss.
The implementation here is free-standing: a stateless line formatter plus
a minimal stateful wrapper the engine drives with absolute values.
``enabled`` is tied to the engine's ``verbose`` flag.
"""

from __future__ import annotations

import sys
import time

_BAR_CELLS = 30


def pretty_time(seconds):
    t = int(round(seconds))
    return "%d:%02d:%02d" % (t // 3600, t // 60 % 60, t % 60)


def format_line(value, lo, hi, elapsed, width=_BAR_CELLS):
    """Render one progress line (pure function of its inputs)."""
    span = hi - lo
    frac = 1.0 if span == 0 else (value - lo) / span
    filled = int(round(frac * width))
    eta = 0.0 if frac <= 0 else elapsed * (1.0 - frac) / frac
    shown = "(%g of %g)" % (value, hi) if lo == 0 else "(%g)" % value
    return " ".join(
        [
            "%3.0f%%" % (frac * 100.0),
            shown,
            "[%s%s]" % ("#" * filled, "-" * (width - filled)),
            pretty_time(elapsed),
            pretty_time(eta),
        ]
    )


class Bar:
    """Stateful wrapper: tracks the start time and last value.

    API kept from the reference so user scripts that poke at the bar keep
    working: ``update(value)`` / ``increment(delta)`` / ``done()`` /
    ``stop()`` plus the ``value`` attribute.
    """

    def __init__(self, max_value=100, min_value=0, enabled=True):
        self.min_value = min_value
        self.max_value = max_value
        self.value = min_value
        self.enabled = enabled
        self._t0 = time.monotonic()

    @property
    def elapsed_time(self):
        return time.monotonic() - self._t0

    def render(self):
        return format_line(
            self.value, self.min_value, self.max_value, self.elapsed_time
        )

    def increment(self, delta):
        self.update(self.value + delta)

    def update(self, value):
        self.value = value
        if self.enabled:
            sys.stdout.write("  %s    \r" % self.render())
            sys.stdout.flush()

    def done(self):
        self.update(self.max_value)
        self.stop()

    def stop(self):
        if self.enabled:
            sys.stdout.write("\n")
            sys.stdout.flush()
