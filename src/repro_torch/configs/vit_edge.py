"""vit-edge — the paper's own case study backbone (ViT-B/16-like encoder used
for the flower-classification GaisNet experiments, §V) at edge scale."""
from repro_torch.configs.base import ModelConfig, PEFTConfig, register

CONFIG = register(ModelConfig(
    name="vit-edge", family="dense", citation="paper §V (ViT-B/16 case study)",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=1000,
    peft=PEFTConfig(n_prefix=16, lora_rank=8, head_dim_out=5),
))
