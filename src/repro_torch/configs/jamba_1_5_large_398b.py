"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2, Mamba+attention 1:7 interleave
[arXiv:2403.19887].

Stack: 9 groups x (1 attn + 7 mamba) = 72 layers; MoE on every other layer
(4 MoE + 4 dense FFN per group).  The training fields (FSDP, microbatches)
are kept so the config compares field for field with the reference; one
device ignores them.  One 8-layer group is 45.25 B parameters (90.5 GB in
bf16), more than one card holds: the card runs this pattern as a small
model only.
"""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        group_pattern=(
            ("attn", "moe"), ("mamba", "dense"),
            ("mamba", "moe"), ("mamba", "dense"),
            ("mamba", "moe"), ("mamba", "dense"),
            ("mamba", "moe"), ("mamba", "dense"),
        ),
        num_experts=16,
        num_experts_per_tok=2,
        moe_d_ff=24576,
        ssm_state=128,
        ssm_d_inner=16384,
        ssm_head_dim=64,
        ssm_n_groups=8,
        ssm_chunk=256,
        ffn_activation="silu",
        gated_ffn=True,
        use_fsdp=True,
        num_microbatches=8,
        norm_eps=1e-5,
        expected_params=398_000_000_000,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_heads=8, num_kv_heads=2, num_experts=4,
                       ssm_n_groups=2, num_microbatches=1)
