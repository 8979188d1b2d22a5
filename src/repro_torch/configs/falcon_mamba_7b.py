"""falcon-mamba-7b — attention-free Mamba-1 SSM [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b", family="ssm", citation="arXiv:2410.05355",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=65024, head_dim=64,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
))
