"""whisper-large-v3 [audio] — encoder-decoder; the conv/mel frontend is a
stub (the model takes precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.config import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,  # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    mlp="gelu",
    norm="layernorm",
    encoder=EncoderConfig(n_layers=32, n_frames=1500),
    frontend="audio",
    rope=False,  # absolute sinusoidal positions
    source="arXiv:2212.04356 (unverified)",
)
