"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

SWA (window 4096) bounds the decode KV working set.  The sharding rule
override (expert FFN dims over the model axis) is kept so the config
compares field for field with the reference; one device ignores it.
"""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        group_pattern=(("attn", "moe"),),
        num_experts=8,
        num_experts_per_tok=2,
        moe_d_ff=14336,
        sliding_window=4096,
        ffn_activation="silu",
        gated_ffn=True,
        rope_theta=1_000_000.0,
        norm_eps=1e-5,
        sharding_overrides=(("expert_ffn", "model"),),
        expected_params=46_702_792_704,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_experts=4, num_kv_heads=2)
