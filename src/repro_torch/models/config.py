"""Model configuration: a copy of the reference package's ``ModelConfig``
and ``scaled_down`` with the same fields, defaults and parameter
accounting, so a config built here compares field for field with the
reference one.

The one change: ``"auto"`` decode attention resolves from the device of
the cache tensor (``resolve_decode_attention_impl``) instead of asking a
framework for its backend.  Every field is runnable in this package but
``decode_unroll_layers``, which ``repro_torch.models.model`` refuses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

MIXER_KINDS = ("attn", "mamba", "cross_attn")
FFN_KINDS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer stack: pattern of (mixer, ffn); stack = pattern * num_groups
    group_pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)

    # attention
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"      # rope | sinusoidal | none
    sliding_window: Optional[int] = None
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None

    # ffn
    ffn_activation: str = "silu"     # silu | gelu
    gated_ffn: bool = True

    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # GShard-style dispatch groups: tokens are dispatched within groups so a
    # group maps to one data shard and the scatter/gather is collective-free.
    # 1 = global dispatch. Set to the batch-shard count by the launcher.
    moe_groups: int = 1

    # ssm (mamba2 / jamba)
    ssm_state: int = 0
    ssm_d_inner: int = 0
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 128

    # decode cache-update strategy:
    #   onehot  - arithmetic read-modify-write of the whole cache (baseline)
    #   scatter - per-request scatter of the new row (ragged-safe)
    #   uniform - dynamic_update_slice at kv_lens[0] (static-bucket serving:
    #             all slots share the position; cheapest)
    decode_cache_update: str = "onehot"
    # unrolled decode with per-group cache leaves (the reference package's
    # aliasing option); this package updates caches in place and raises on
    # True
    decode_unroll_layers: bool = False
    # KV-cache layout: "bshd" (baseline) or "bhsd" (head-major; decode
    # reads it with the plain decode_attention, as the reference does)
    cache_layout: str = "bshd"
    # decode attention implementation:
    #   auto   - ragged on CUDA, dense on the CPU; resolved at use time
    #            from the cache tensor's device via
    #            ``resolve_decode_attention_impl``.
    #   dense  - padded softmax over the full cache span (baseline,
    #            always selectable)
    #   ragged - repro_torch.kernels ragged decode kernel: per-request
    #            early exit, so early-finished slots stop paying padded KV
    #            reads. bshd layout only. The kernel's loop stops at each
    #            request's length, so any cache span works.
    decode_attention_impl: str = "auto"

    # vlm
    vision_seq: int = 0              # stub patch-embedding length
    # audio
    embeddings_input: bool = False   # frontend stub feeds embeddings directly

    # embedding / head
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma-style sqrt(d_model) scaling
    vocab_pad_to: int = 128
    norm_eps: float = 1e-5

    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    use_fsdp: bool = False           # shard embed dim over data axis
    num_microbatches: int = 1        # grad-accumulation microbatches
    attn_chunk_q: int = 512          # blockwise attention q block
    attn_chunk_kv: int = 512         # blockwise attention kv block
    attn_dense_max_seq: int = 4096   # use dense attention at/below this seqlen
    logits_fp32: bool = True

    # per-arch logical->mesh sharding rule overrides (e.g. mixtral's 8
    # experts don't divide the 16-way model axis, so its expert FFN dim
    # shards instead). Tuple of (logical, axis) pairs (hashable).
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()

    # expected parameter count from the source (for MODEL_FLOPS accounting);
    # 0 means "use the exact computed count".
    expected_params: int = 0

    def __post_init__(self):
        assert self.num_layers % len(self.group_pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"pattern length {len(self.group_pattern)}")
        for mixer, ffn in self.group_pattern:
            assert mixer in MIXER_KINDS and ffn in FFN_KINDS

    # ---------------- derived properties ----------------

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.group_pattern)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_heads(self) -> int:
        if not self.ssm_d_inner:
            return 0
        assert self.ssm_d_inner % self.ssm_head_dim == 0
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def ssm_conv_dim(self) -> int:
        return self.ssm_d_inner + 2 * self.ssm_n_groups * self.ssm_state

    def resolve_decode_attention_impl(self, device) -> str:
        """``decode_attention_impl`` with ``"auto"`` resolved from the
        device of the cache tensor it will run on: the hand-written ragged
        kernel on CUDA, the dense padded softmax on the CPU.  Explicit
        ``"dense"``/``"ragged"`` always win (on the CPU the ragged wrapper
        runs its plain PyTorch version)."""
        if self.decode_attention_impl != "auto":
            return self.decode_attention_impl
        return "ragged" if device.type == "cuda" else "dense"

    @property
    def has_attention(self) -> bool:
        return any(m in ("attn", "cross_attn") for m, _ in self.group_pattern)

    @property
    def subquadratic(self) -> bool:
        """True when decode-time context cost is sub-quadratic: SSM/hybrid
        stacks, or attention bounded by a sliding window."""
        if not self.has_attention:
            return True
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    # ---------------- parameter accounting ----------------

    def _layer_params(self, mixer: str, ffn: str) -> int:
        d = self.d_model
        n = 0
        if mixer == "attn" or mixer == "cross_attn":
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                n += self.q_dim + 2 * self.kv_dim
            n += 2 * d  # input norms (pre-mixer, pre-ffn)
            if mixer == "cross_attn":
                n += 2                      # attn + ffn tanh gates
                n += 2 * self.head_dim      # q/k norms
        elif mixer == "mamba":
            din = self.ssm_d_inner
            proj_out = 2 * din + 2 * self.ssm_n_groups * self.ssm_state + self.ssm_heads
            n += d * proj_out                       # in_proj
            n += self.ssm_conv_dim * self.ssm_conv_kernel
            n += 3 * self.ssm_heads                 # A_log, D, dt_bias
            n += din                                # gated norm
            n += din * d                            # out_proj
            n += d                                  # pre-mixer norm
            if ffn != "none":
                n += d
        if ffn == "dense":
            mult = 3 if self.gated_ffn else 2
            n += mult * d * self.d_ff
        elif ffn == "moe":
            mult = 3 if self.gated_ffn else 2
            n += self.num_experts * mult * d * self.moe_d_ff
            n += d * self.num_experts               # router
            if self.num_shared_experts:
                n += self.num_shared_experts * mult * d * self.moe_d_ff
        return n

    def param_count(self) -> int:
        n = self.padded_vocab * self.d_model        # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model   # lm head
        n += self.d_model                           # final norm
        per_group = sum(self._layer_params(m, f) for m, f in self.group_pattern)
        n += per_group * self.num_groups
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE counts only routed experts)."""
        n = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        n += self.d_model
        per_group = 0
        for m, f in self.group_pattern:
            p = self._layer_params(m, "none" if f == "moe" else f)
            if f == "moe":
                mult = 3 if self.gated_ffn else 2
                p += (self.num_experts_per_tok + self.num_shared_experts) * \
                    mult * self.d_model * self.moe_d_ff
                p += self.d_model * self.num_experts
            per_group += p
        n += per_group * self.num_groups
        return n

    def model_flops(self, tokens: int, *, training: bool) -> float:
        """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for inference."""
        mult = 6.0 if training else 2.0
        return mult * self.active_param_count() * tokens


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Produce a smoke-test-sized variant of a config (same family/pattern)."""
    pat = cfg.group_pattern
    small = dict(
        num_layers=len(pat) * overrides.pop("num_groups", 1),
        d_model=overrides.pop("d_model", 64),
        num_heads=overrides.pop("num_heads", 4),
        num_kv_heads=overrides.pop("num_kv_heads", min(cfg.num_kv_heads, 2)),
        head_dim=overrides.pop("head_dim", 16),
        d_ff=overrides.pop("d_ff", 128),
        vocab_size=overrides.pop("vocab_size", 512),
        num_experts=(overrides.pop("num_experts", 4) if cfg.num_experts else 0),
        moe_d_ff=(overrides.pop("moe_d_ff", 64) if cfg.num_experts else 0),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        ssm_d_inner=(overrides.pop("ssm_d_inner", 128) if cfg.ssm_d_inner else 0),
        ssm_state=(overrides.pop("ssm_state", 16) if cfg.ssm_state else 0),
        ssm_head_dim=(overrides.pop("ssm_head_dim", 32) if cfg.ssm_d_inner else 64),
        ssm_chunk=overrides.pop("ssm_chunk", 32),
        vision_seq=(overrides.pop("vision_seq", 16) if cfg.vision_seq else 0),
        sliding_window=(overrides.pop("sliding_window", 32)
                        if cfg.sliding_window else None),
        attn_dense_max_seq=overrides.pop("attn_dense_max_seq", 128),
        attn_chunk_q=overrides.pop("attn_chunk_q", 32),
        attn_chunk_kv=overrides.pop("attn_chunk_kv", 32),
        expected_params=0,
        name=cfg.name + "-smoke",
        remat=False,
        dtype=overrides.pop("dtype", "float32"),
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
