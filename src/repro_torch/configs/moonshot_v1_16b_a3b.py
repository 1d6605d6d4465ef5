"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, MoE 64 experts top-6 + 2 shared experts
[hf:moonshotai/Moonlight-16B-A3B, deepseek-v3-style].

Deviation, as in the reference: ``first_k_dense_replace=1`` omitted so the
layer stack stays homogeneous (<0.5% of parameters).  The 48L x 64e
config holds ~28.9B parameters (the released Moonlight-16B has 27 layers);
it is the reference's config verbatim, with its exact parameter count.
"""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=11264,              # dense-equivalent (unused; all layers MoE)
        vocab_size=163840,
        group_pattern=(("attn", "moe"),),
        num_experts=64,
        num_experts_per_tok=6,
        num_shared_experts=2,
        moe_d_ff=1408,
        ffn_activation="silu",
        gated_ffn=True,
        rope_theta=50_000.0,
        norm_eps=1e-5,
        expected_params=28_888_467_456,   # the 48L config (see docstring)
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_experts=8, num_kv_heads=4)
