"""Plain PyTorch references of the configurations the benchmark runs.
They import neither ``jax`` nor anything of the program."""
