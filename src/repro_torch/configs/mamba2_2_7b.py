"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified tier].

d_inner = 2*d_model = 5120, head_dim 64 -> 80 heads.  Vocab padded 50280 ->
50304 (a multiple of 128).  The decode state is O(1) in the sequence: a
conv window and an SSM state per layer (``models.mamba``).
"""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        group_pattern=(("mamba", "none"),),
        ssm_state=128,
        ssm_d_inner=5120,
        ssm_head_dim=64,
        ssm_n_groups=1,
        ssm_chunk=256,
        tie_embeddings=True,
        norm_eps=1e-5,
        expected_params=2_702_599_680,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_heads=0, num_kv_heads=0, head_dim=0,
                       d_ff=0, ssm_n_groups=1)
