"""Set-up: process start to the window's start, seconds (host clock)."""


def read(obs):
    return obs.get("setup_s")
