"""Model step: model FLOPs of the work done in the window (prompts
admitted, tokens produced) over its length, as a share of 989 TFLOP/s,
%."""
from portbench.lib import readers as R


def read(obs):
    return R.window_mfu(obs)
