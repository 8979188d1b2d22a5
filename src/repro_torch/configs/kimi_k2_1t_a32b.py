"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

Homogenized: the first dense layer is folded into the uniform 61-layer MoE
stack so layers scan (DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", citation="arXiv:2501.kimi2",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared_experts=1),
))
