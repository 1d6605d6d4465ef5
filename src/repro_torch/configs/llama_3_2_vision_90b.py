"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attention image layers
[hf:meta-llama/Llama-3.2-90B-Vision; unverified tier].

Stack: 20 groups x (4 self-attn + 1 cross-attn) = 100 layers.  The vision
tower is a stub: the caller hands ``prefill`` precomputed patch embeddings
[batch, vision_seq=6400, d_model] (``cross_kv``), which the cross-attention
positions project to K/V and cache for decode.  ``use_fsdp`` and
``num_microbatches`` are kept so the config compares field for field with
the reference's; the port runs on one device and reads neither.
"""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        group_pattern=(
            ("attn", "dense"), ("attn", "dense"), ("attn", "dense"),
            ("attn", "dense"), ("cross_attn", "dense"),
        ),
        vision_seq=6400,
        ffn_activation="silu",
        gated_ffn=True,
        rope_theta=500_000.0,
        use_fsdp=True,
        num_microbatches=8,
        norm_eps=1e-5,
        expected_params=88_600_000_000,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_heads=8, num_kv_heads=2, num_microbatches=1)
