"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
the torch oracles (``ref.py``) and the dispatch layer (``ops.py``)."""
