"""Kernels: sum of the roofline bounds over the sum of the device time of
the LoRA kernels' calls in the traced sub-window, %."""
from portbench.lib import readers as R


def read(obs):
    return R.roofline(obs, "lora")
