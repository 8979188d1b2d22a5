"""qwen1.5-32b — dense MHA (kv=40) with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b", family="dense", citation="hf:Qwen/Qwen1.5-0.5B",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
))
