"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

LLaMA-architecture GQA [arXiv:2403.04652].
"""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        ffn_activation="silu",
        gated_ffn=True,
        rope_theta=5_000_000.0,
        norm_eps=1e-6,
        expected_params=8_829_407_232,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_heads=8, num_kv_heads=2)
