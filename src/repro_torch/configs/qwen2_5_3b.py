"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936. GQA with QKV bias [hf:Qwen/Qwen2.5-*]."""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        ffn_activation="silu",
        gated_ffn=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        norm_eps=1e-6,
        expected_params=3_085_938_688,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_kv_heads=2)
