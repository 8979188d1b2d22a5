"""Model step: the host time of the ``layer.attn`` spans inside the
``model.decode_step`` spans begun in the window, over those steps' host
time, %."""
from portbench.lib import program


def read(obs):
    sp = program.spans(program.telemetry(obs), *obs["window"])
    if not sp or "layer.attn" not in sp["total"]:
        return None
    return 100.0 * sp["total"]["layer.attn"] / sum(sp["steps"])
