"""Device: one minus the union of the device's kernel, copy and fill
intervals over the traced sub-window, %."""
from portbench.lib import readers as R


def read(obs):
    return R.idle_share(obs)
