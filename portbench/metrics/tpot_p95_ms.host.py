"""Engine layer, recorded above the knee: 95th percentile over the window's
requests of (completion - first token) / (output tokens - 1), ms."""
from portbench.lib import readers as R


def read(obs):
    return R.p95(R.tpot_ms(obs))
