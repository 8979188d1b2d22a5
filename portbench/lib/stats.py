"""Statistics over raw samples (no histogram buckets)."""
from __future__ import annotations

import numpy as np


def pct(values, q: float):
    """The q-th percentile of the raw samples (linear interpolation);
    None for no sample."""
    v = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(v, q)) if v.size else None
