"""llava-next-mistral-7b — VLM, anyres tiling (vision tower stubbed)
[hf:llava-hf/llava-v1.6-mistral-7b-hf]. Mistral backbone uses SWA-4096."""
from repro_torch.configs.base import ModelConfig, VLMConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, attn_variant="sliding", sliding_window=4096,
    vlm=VLMConfig(n_vis_tokens=576),
))
