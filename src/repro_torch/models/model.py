"""Model assembly: embeddings -> stacked layer groups -> head.

The layer stack is ``cfg.group_pattern`` repeated ``cfg.num_groups`` times
with parameters (and caches) stacked over a leading group dim, as in
``repro.models.model``; the reference's ``lax.scan`` over groups is a
Python loop here.  Attention and Mamba2 positions (``models.mamba``) with
a dense, MoE (``models.moe``) or no FFN and the bshd cache layout are
ported; cross-attention positions, sinusoidal positions, embedding
inputs, the bhsd layout and ``decode_unroll_layers`` raise
``NotImplementedError`` (see ROADMAP.md, queue 1, M8).

Every norm is the fused residual-add + RMSNorm (``kernels.rmsnorm``): the
residual add of each branch is deferred to the next norm site, and the
last one to ``final_norm`` in the head.  The norm at a group's first
position and ``final_norm`` normalise that sum rounded to the activations'
dtype (``round_sum``): the reference's scan over groups carries the
residual stream in that dtype.  In fp32 the rounding changes nothing.

Two entry points serve the engine:
  prefill(...)      the prompt; writes the KV / SSM caches, returns last
                    logits
  decode_step(...)  one token against the caches (updated in place)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import resolve_device
from repro_torch.kernels.rmsnorm import fused_rmsnorm
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import mamba_block, mamba_specs
from repro_torch.models.moe import moe_block, moe_specs
from repro_torch.models.params import Spec, map_tree, stack_specs


def check_supported(cfg: ModelConfig):
    """Raise on the parts of ``ModelConfig`` this package does not run."""
    for mixer, ffn in cfg.group_pattern:
        if mixer not in ("attn", "mamba") or ffn not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: ({mixer}, {ffn}) positions are not ported yet "
                "(ROADMAP.md, queue 1, M8)")
    if cfg.pos_embedding not in ("rope", "none") or cfg.embeddings_input:
        raise NotImplementedError(
            f"{cfg.name}: sinusoidal positions and embedding inputs are not "
            "ported yet (ROADMAP.md, queue 1, M8)")
    if cfg.cache_layout != "bshd":
        raise NotImplementedError("cache_layout='bhsd' is not ported yet")
    if cfg.decode_unroll_layers:
        raise NotImplementedError("decode_unroll_layers is not ported; "
                                  "caches are updated in place instead")


# ----------------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------------

def _position_specs(cfg: ModelConfig, mixer: str, ffn: str):
    s = {"pre_norm": L.rmsnorm_specs(cfg.d_model),
         "mixer": (L.attention_specs(cfg) if mixer == "attn"
                   else mamba_specs(cfg))}
    if ffn != "none":
        s["ffn"] = L.ffn_specs(cfg) if ffn == "dense" else moe_specs(cfg)
        s["ffn_norm"] = L.rmsnorm_specs(cfg.d_model)
    return s


def param_specs(cfg: ModelConfig):
    check_supported(cfg)
    group = {f"pos{i}": _position_specs(cfg, mixer, ffn)
             for i, (mixer, ffn) in enumerate(cfg.group_pattern)}
    specs = {
        "embed": Spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed")),
        "final_norm": L.rmsnorm_specs(cfg.d_model),
        "groups": stack_specs(group, cfg.num_groups),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """Spec tree for the decode caches (stacked over groups)."""
    check_supported(cfg)
    g = cfg.num_groups
    tree = {}
    for i, (mixer, _) in enumerate(cfg.group_pattern):
        if mixer == "attn":
            span = max_seq if cfg.sliding_window is None else min(
                max_seq, cfg.sliding_window)
            shp = (g, batch, span, cfg.num_kv_heads, cfg.head_dim)
            ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
            tree[f"pos{i}"] = {"k": Spec(shp, ax, init="zeros"),
                               "v": Spec(shp, ax, init="zeros")}
        else:
            ck = (g, batch, cfg.ssm_conv_kernel - 1, cfg.ssm_conv_dim)
            ss = (g, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
            tree[f"pos{i}"] = {
                "conv": Spec(ck, ("layers", "batch", None, "conv_dim"),
                             init="zeros"),
                "ssm": Spec(ss, ("layers", "batch", "ssm_heads", None,
                                 "ssm_state"), init="zeros"),
            }
    return tree


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               cache_dtype=torch.bfloat16, device=None):
    """Zero caches on ``device`` (None: CUDA, and an error if there is
    none)."""
    device = resolve_device(device)
    return map_tree(
        lambda s: torch.zeros(s.shape, dtype=cache_dtype, device=device),
        cache_specs(cfg, batch, max_seq))


# ----------------------------------------------------------------------------
# Group application
# ----------------------------------------------------------------------------

def _apply_position(cfg: ModelConfig, mixer: str, ffn: str, p, x, delta, *,
                    positions, pos_cache, kv_lens, rope, first=False):
    """One (mixer, ffn) layer.  ``x`` is the residual stream and ``delta``
    the previous branch's output, not yet added: the fused kernel adds it
    while it normalizes (rounding the sum first at a group's ``first``
    position).  Returns (x, delta, pos_cache); an MoE FFN's load-balance
    loss is not needed for serving and is dropped."""
    x, h = fused_rmsnorm(delta, x, p["pre_norm"], eps=cfg.norm_eps,
                         round_sum=first)
    if mixer == "attn":
        out, pos_cache = L.attention_block(
            p["mixer"], h, cfg, positions=positions, cache=pos_cache,
            kv_lens=kv_lens, rope=rope)
    else:
        out, pos_cache = mamba_block(p["mixer"], h, cfg, state=pos_cache)
    if ffn == "none":
        return x, out, pos_cache
    x, h2 = fused_rmsnorm(out, x, p["ffn_norm"], eps=cfg.norm_eps)
    if ffn == "dense":
        return x, L.ffn_block(p["ffn"], h2, cfg), pos_cache
    return x, moe_block(p["ffn"], h2, cfg)[0], pos_cache


def _run_groups(cfg: ModelConfig, params, x, *, positions, cache, kv_lens):
    """Loop over the stacked group dim; layer g reads the views
    ``leaf[g]`` of the stacked params and caches (cache writes land in the
    stacked tensors).  Returns (x, delta): the residual stream and the last
    branch output, which ``_head`` adds as it applies ``final_norm``.  The
    first layer adds the embeddings to a zero stream, so every norm of the
    model goes through the fused kernel."""
    rope = (L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.has_attention and cfg.pos_embedding == "rope" else None)
    x, delta = torch.zeros_like(x), x
    for g in range(cfg.num_groups):
        gparams = map_tree(lambda leaf: leaf[g], params["groups"])
        for i, (mixer, ffn) in enumerate(cfg.group_pattern):
            key = f"pos{i}"
            pos_cache = None
            if cache is not None:
                pos_cache = {name: leaf[g] for name, leaf in cache[key].items()}
            x, delta, _ = _apply_position(
                cfg, mixer, ffn, gparams[key], x, delta, positions=positions,
                pos_cache=pos_cache, kv_lens=kv_lens, rope=rope, first=i == 0)
    return x, delta


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params, tokens):
    tok = torch.clamp(tokens, 0, cfg.padded_vocab - 1)
    x = F.embedding(tok.long(), params["embed"].to(
        torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32))
    if cfg.scale_embeddings:
        # gemma's sqrt(d_model), rounded to the activations' dtype before
        # the multiply, as the reference does (55.43 is 55.5 in bf16); a
        # host scalar, so a captured decode graph holds no copy
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def _head(cfg: ModelConfig, params, x, delta):
    _, x = fused_rmsnorm(delta, x, params["final_norm"], eps=cfg.norm_eps,
                         round_sum=True)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, w.to(x.dtype))
    if cfg.logits_fp32:
        logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)
    return logits


def prefill(cfg: ModelConfig, params, tokens, *, cache, prompt_lens=None):
    """Run the prompt, fill the caches (in place), return (last-position
    logits [B, vocab], cache).  Only the rows at ``prompt_lens - 1`` go
    through the head: the head is row-wise, so this equals the reference's
    take-after-head and skips a [B, S, vocab] logits tensor."""
    check_supported(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    if prompt_lens is None:
        prompt_lens = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)
    x = _embed_inputs(cfg, params, tokens)
    x, delta = _run_groups(cfg, params, x, positions=positions, cache=cache,
                           kv_lens=prompt_lens)
    last = (prompt_lens.long() - 1).view(b, 1, 1).expand(b, 1, x.shape[-1])
    return _head(cfg, params, torch.gather(x, 1, last),
                 torch.gather(delta, 1, last))[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, kv_lens):
    """One decode step. tokens: [B] int32; kv_lens: [B] current lengths.

    Returns (logits [B, vocab], cache); the cache tensors are updated in
    place (the reference donates them to its jitted step instead)."""
    check_supported(cfg)
    positions = kv_lens[:, None]
    x = _embed_inputs(cfg, params, tokens[:, None])
    x, delta = _run_groups(cfg, params, x, positions=positions, cache=cache,
                           kv_lens=kv_lens)
    return _head(cfg, params, x, delta)[:, 0], cache
