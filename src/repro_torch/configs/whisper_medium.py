"""whisper-medium [audio] — enc-dec transformer backbone; conv frontend is a
stub (input_specs provides precomputed frame embeddings). [arXiv:2212.04356]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    is_encoder_decoder=True, n_encoder_layers=24, encoder_seq=1500,
    frontend="audio_stub",
)
