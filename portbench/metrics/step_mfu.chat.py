"""Model step: model FLOPs of every decode token served over the time of
every decode segment, as a share of 989 TFLOP/s, %."""
from portbench.lib import readers as R


def read(obs):
    return R.segment_mfu(obs)
