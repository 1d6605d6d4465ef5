"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297]."""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92544,
        ffn_activation="silu",
        gated_ffn=True,
        rope_theta=1_000_000.0,
        norm_eps=1e-5,
        expected_params=1_889_110_016,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config())
