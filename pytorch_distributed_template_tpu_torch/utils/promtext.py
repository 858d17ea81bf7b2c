"""The one percentile convention of the serving stack: a copy of the JAX
package's ``utils/promtext.percentile`` (the rest of that module, the
Prometheus exposition helpers and histograms, is a later slice)."""
from __future__ import annotations

from typing import List, Optional


def percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile over a pre-sorted list (the
    numpy/``histogram_quantile`` convention); None when empty."""
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * frac
