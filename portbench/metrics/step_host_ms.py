"""Model step: the mean host time of the program's ``model.decode_step``
spans begun in the window (no sync inside: beside ``decode_step_ms``, how
far the host paces the step), ms."""
from portbench.lib import program


def read(obs):
    sp = program.spans(program.telemetry(obs), *obs["window"])
    return 1e3 * sum(sp["steps"]) / len(sp["steps"]) if sp else None
