"""whisper-small — encoder-decoder, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import AudioConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small", family="audio", citation="arXiv:2212.04356",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    audio=AudioConfig(n_enc_layers=12, n_audio_frames=1500),
))
