"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU activation, head_dim=256, tied embeddings with sqrt(d) input scaling
[arXiv:2403.08295].
"""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        ffn_activation="gelu",
        gated_ffn=True,
        tie_embeddings=True,
        scale_embeddings=True,
        norm_eps=1e-6,
        expected_params=8_537_680_896,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_kv_heads=4, head_dim=32)
