"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
))
