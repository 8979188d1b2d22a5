"""recurrentgemma-2b — RG-LRU + local attention, 1:2 [arXiv:2402.19427].

26 layers = 8 scanned (rglru, rglru, attn) blocks + unrolled (rglru, rglru) tail.
"""
from repro_torch.configs.base import ModelConfig, HybridConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid", citation="arXiv:2402.19427",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, tie_embeddings=True,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"),
                        tail=("rglru", "rglru"), lru_width=2560, window=2048),
))
