"""Engine layer, recorded above the knee: 95th percentile over the window's
requests of first token host-visible minus the time the request was due,
seconds."""
from portbench.lib import readers as R


def read(obs):
    return R.p95(R.ttft_s(obs))
