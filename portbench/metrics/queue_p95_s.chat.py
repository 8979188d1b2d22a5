"""Engine layer: 95th percentile of admission into a wave minus the due
time, seconds, over the window's requests."""
from portbench.lib import readers as R


def read(obs):
    return R.p95(R.queue_s(obs))
