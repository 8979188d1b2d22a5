"""Engine layer: slot-steps that served nothing over all decode slot-steps
of the window's drains, %."""
from portbench.lib import readers as R


def read(obs):
    return R.padded_share(obs)
