"""Model step: the host time of the ``layer.ffn`` spans (the MLP, or the
moe FFN) inside the ``model.decode_step`` spans begun in the window, over
those steps' host time, %."""
from portbench.lib import program


def read(obs):
    sp = program.spans(program.telemetry(obs), *obs["window"])
    if not sp or "layer.ffn" not in sp["total"]:
        return None
    return 100.0 * sp["total"]["layer.ffn"] / sum(sp["steps"])
