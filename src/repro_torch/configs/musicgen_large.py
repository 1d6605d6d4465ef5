"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens [arXiv:2306.05284].  The
modality frontend is a stub: ``prefill`` takes precomputed frame
embeddings (``embeds=``) as well as token ids; the backbone is MHA with
heads of 64, a non-gated GELU FFN and sinusoidal positions.
"""

from repro_torch.models.config import ModelConfig, scaled_down


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        ffn_activation="gelu",
        gated_ffn=False,
        pos_embedding="sinusoidal",
        embeddings_input=True,
        norm_eps=1e-5,
        expected_params=2_022_801_408,
    )


def smoke_config() -> ModelConfig:
    return scaled_down(config(), num_kv_heads=4, vocab_size=256)
