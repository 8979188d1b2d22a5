"""Engine: the mean ``device_ms`` of the program's ``engine.refill`` spans
begun in the window (stream time from a refill's first launch to its
last op's completion, what the rows waiting on it feel), ms."""
from portbench.lib import program


def read(obs):
    ms = program.device_ms(program.telemetry(obs), "engine.refill",
                           *obs["window"])
    return sum(ms) / len(ms) if ms else None
