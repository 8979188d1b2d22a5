"""The port's benchmark: one command runs one cell (a model configuration
under one traffic mix) of ``BENCHMARK.json`` on the card and prints one
JSON result line. See ``run.py``."""
