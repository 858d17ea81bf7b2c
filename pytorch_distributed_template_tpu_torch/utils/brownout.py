"""Brownout ladder: ordered degradation under overload (a copy of the
JAX package's ``utils/brownout.py``).

"The Tail at Scale" calls the alternative to falling over *graceful
degradation*: when pressure (queue depth, pool occupancy, SLO breach
rate) exceeds what the replica can absorb, shed QUALITY before
shedding REQUESTS, one reversible step at a time:

====== ===============  ==============================================
level  name             effect (owner in parentheses)
====== ===============  ==============================================
0      ``normal``       nothing degraded
1      ``no_spec``      speculative decode disabled — its extra
                        verify-call bandwidth goes back to the batch
                        (continuous engine / serve.py)
2      ``short_chunks`` adaptive chunk growth capped at the base
                        chunk: admission latency for waiting requests
                        beats saturated-throughput batching
                        (continuous engine)
3      ``clamp_budget`` admitted ``max_new_tokens`` capped — long
                        generations finish short (``stop_reason``
                        stays honest) so slots recycle (continuous
                        engine admission)
4      ``shed_tenants`` per-tenant waiting-room slices tighten —
                        the heaviest tenants shed first, light ones
                        keep flowing (fleet admission gate)
====== ===============  ==============================================

The controller is a pure state machine over a scalar *pressure*
signal (callers normalize their own signals; 1.0 ≈ "at capacity"):
levels RISE as soon as pressure crosses an enter threshold, and FALL
one step at a time only after pressure drops below the (lower) exit
threshold AND the level has been held for ``dwell_s`` — classic
hysteresis, so a noisy signal cannot flap the ladder. Stdlib-only:
the continuous engine drives levels 1-3; level 4 belongs to the fleet's
admission gate, which the port does not have yet (ROADMAP A13).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

LEVEL_NAMES = ("normal", "no_spec", "short_chunks", "clamp_budget",
               "shed_tenants")

#: default thresholds, in units of normalized pressure (1.0 ≈ at
#: capacity). enter[i] is the pressure at which level i+1 engages;
#: exit[i] the pressure below which level i+1 releases (strictly
#: lower — the hysteresis band).
DEFAULT_ENTER = (1.0, 2.0, 3.0, 4.0)
DEFAULT_EXIT = (0.5, 1.0, 1.5, 2.0)


class BrownoutController:
    """Hysteresis ladder over a scalar pressure signal.

    :param enter: per-level engage thresholds (len = max level).
    :param exit: per-level release thresholds; each must be < its
        enter twin or the ladder would flap on a constant signal.
    :param dwell_s: minimum time at a level before it may step DOWN
        (steps up are immediate — overload does not wait).
    :param on_change: ``f(old_level, new_level, pressure)`` callback
        fired on every transition (recorder/event-log hook).
    :param time_fn: injectable clock (tests drive it manually).
    """

    def __init__(self, enter: Sequence[float] = DEFAULT_ENTER,
                 exit: Sequence[float] = DEFAULT_EXIT,  # noqa: A002
                 dwell_s: float = 2.0,
                 on_change: Optional[Callable] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        enter = tuple(float(x) for x in enter)
        exit_ = tuple(float(x) for x in exit)
        if len(enter) != len(exit_) or not enter:
            raise ValueError("enter/exit thresholds must be "
                             "non-empty and the same length")
        if any(b >= a for a, b in zip(enter, exit_)):
            raise ValueError(
                f"every exit threshold must be strictly below its "
                f"enter twin (hysteresis): enter={enter} exit={exit_}")
        if any(b > a for a, b in zip(enter[1:], enter)):
            raise ValueError(f"enter thresholds must be "
                             f"non-decreasing: {enter}")
        self.enter = enter
        self.exit = exit_
        self.dwell_s = float(dwell_s)
        self.on_change = on_change
        self._time = time_fn
        self.level = 0
        self.max_level = len(enter)
        self._t_change = self._time()
        self.transitions_total = 0
        self.peak_level = 0

    def name(self) -> str:
        return LEVEL_NAMES[min(self.level, len(LEVEL_NAMES) - 1)]

    def update(self, pressure: float) -> int:
        """Feed one pressure observation; returns the (possibly
        changed) level. Rises are immediate and may jump multiple
        levels in one update (a cliff is a cliff); falls are one step
        per dwell window."""
        pressure = float(pressure)
        now = self._time()
        old = self.level
        while (self.level < self.max_level
               and pressure >= self.enter[self.level]):
            self.level += 1
        if (self.level == old and self.level > 0
                and pressure < self.exit[self.level - 1]
                and now - self._t_change >= self.dwell_s):
            self.level -= 1             # one step per dwell window
            self._t_change = now
        if self.level != old:
            if self.level > old:
                self._t_change = now
            self.transitions_total += 1
            self.peak_level = max(self.peak_level, self.level)
            if self.on_change is not None:
                self.on_change(old, self.level, pressure)
        return self.level

    def stats(self) -> dict:
        return {
            "brownout_level": self.level,
            "brownout_transitions_total": self.transitions_total,
            "brownout_peak_level": self.peak_level,
        }
