"""Model step: the engine.segment spans (each ends in its fetch) begun in
the window, summed, over their steps, ms."""
from portbench.lib import readers as R


def read(obs):
    return R.decode_step_ms(obs)
