"""Output tokens produced in the window, of every request the engine
serves there, over the window's length, tokens/s (host clock)."""
from portbench.lib import readers as R


def read(obs):
    return R.window_tok_s(obs)
