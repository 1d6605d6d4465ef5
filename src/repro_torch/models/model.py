"""Model assembly: embeddings -> stacked layer groups -> head.

The layer stack is ``cfg.group_pattern`` repeated ``cfg.num_groups`` times
with parameters (and caches) stacked over a leading group dim, as in
``repro.models.model``; the reference's ``lax.scan`` over groups is a
Python loop here.  Every position kind of the reference runs: attention
(bshd or bhsd caches), cross-attention over image embeddings, Mamba2
(``models.mamba``), with a dense, MoE (``models.moe``) or no FFN; RoPE,
sinusoidal or no positions; token ids or embeddings in.  Only
``decode_unroll_layers`` raises ``NotImplementedError``: caches are
updated in place instead.

Every norm is the fused residual-add + RMSNorm (``kernels.rmsnorm``): the
residual add of each branch is deferred to the next norm site, and the
last one to ``final_norm`` in the head.  The norm at a group's first
position and ``final_norm`` normalise that sum rounded to the activations'
dtype (``round_sum``): the reference's scan over groups carries the
residual stream in that dtype.  In fp32 the rounding changes nothing.

Three entry points:
  forward(...)      full-sequence logits and the summed MoE load-balance
                    loss (training / evaluation), no caches; each layer
                    group is rematerialised under autograd when
                    ``cfg.remat``, as the reference's ``jax.checkpoint``
                    with ``nothing_saveable``
  prefill(...)      the prompt (token ids or ``embeds``, and the image
                    embeddings ``cross_kv`` of a model with cross-attention
                    positions); writes the KV / image-KV / SSM caches,
                    returns last logits
  decode_step(...)  one token against the caches (updated in place)
The two that serve the engine run under ``torch.no_grad()`` there; every
kernel of ``forward``'s path (K3 and K4 on CUDA) has a backward, but for
S8 (the Mamba mixer's chunk-state scan, ROADMAP.md M10b).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import resolve_device
from repro_torch.kernels.rmsnorm import fused_rmsnorm
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import mamba_block, mamba_specs
from repro_torch.models.moe import moe_block, moe_specs
from repro_torch.models.params import Spec, map_tree, stack_specs


def check_supported(cfg: ModelConfig):
    """Raise on the parts of ``ModelConfig`` this package does not run."""
    if cfg.decode_unroll_layers:
        raise NotImplementedError("decode_unroll_layers is not ported; "
                                  "caches are updated in place instead")


# the error of a prefill that a model with cross-attention positions gets
# without image embeddings
NO_IMAGE_EMBEDDINGS = (
    "{name}: cross-attention positions need image embeddings (prefill("
    "cross_kv=...)); the serving engine feeds no image embeddings, as the "
    "reference's does not")


# ----------------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------------

def _position_specs(cfg: ModelConfig, mixer: str, ffn: str):
    s = {"pre_norm": L.rmsnorm_specs(cfg.d_model),
         "mixer": (mamba_specs(cfg) if mixer == "mamba" else
                   L.attention_specs(cfg, cross=mixer == "cross_attn"))}
    if ffn != "none":
        s["ffn"] = L.ffn_specs(cfg) if ffn == "dense" else moe_specs(cfg)
        s["ffn_norm"] = L.rmsnorm_specs(cfg.d_model)
        if ffn == "dense" and mixer == "cross_attn":
            s["ffn_gate"] = Spec((), (), init="zeros")
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
            if cfg.cache_layout == "bhsd":
                shp = (g, batch, cfg.num_kv_heads, span, cfg.head_dim)
                ax = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
            else:
                shp = (g, batch, span, cfg.num_kv_heads, cfg.head_dim)
                ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
            tree[f"pos{i}"] = {"k": Spec(shp, ax, init="zeros"),
                               "v": Spec(shp, ax, init="zeros")}
        elif mixer == "cross_attn":
            # the image K/V, bshd in either layout (as the reference's)
            shp = (g, batch, cfg.vision_seq, cfg.num_kv_heads, cfg.head_dim)
            ax = ("layers", "batch", "vis_seq", "kv_heads", "head_dim")
            tree[f"pos{i}"] = {"k_img": Spec(shp, ax, init="zeros"),
                               "v_img": Spec(shp, ax, init="zeros")}
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
                    positions, pos_cache, kv_lens, rope, cross_kv=None,
                    first=False, with_aux=False):
    """One (mixer, ffn) layer.  ``x`` is the residual stream and ``delta``
    the previous branch's output, not yet added: the fused kernel adds it
    while it normalizes (rounding the sum first at a group's ``first``
    position).  Returns (x, delta, pos_cache, aux): ``aux`` is an MoE
    FFN's load-balance loss with ``with_aux`` (``forward``) and 0.0
    otherwise (serving drops it).  A cross-attention position reads
    ``cross_kv`` at prefill and in ``forward`` (and writes the image K/V
    into its cache when it has one) and the cached image K/V at decode
    (``cross_kv`` None)."""
    x, h = fused_rmsnorm(delta, x, p["pre_norm"], eps=cfg.norm_eps,
                         round_sum=first)
    if mixer == "attn":
        out, pos_cache = L.attention_block(
            p["mixer"], h, cfg, positions=positions, cache=pos_cache,
            kv_lens=kv_lens, rope=rope)
    elif mixer == "cross_attn":
        if cross_kv is None:
            out = L.cross_attention_decode(p["mixer"], h, cfg,
                                           pos_cache["k_img"],
                                           pos_cache["v_img"])
        else:
            out, k, v = L.cross_attention_block(p["mixer"], h, cfg, cross_kv)
            if pos_cache is not None:
                pos_cache["k_img"].copy_(k)
                pos_cache["v_img"].copy_(v)
    else:
        out, pos_cache = mamba_block(p["mixer"], h, cfg, state=pos_cache)
    if ffn == "none":
        return x, out, pos_cache, 0.0
    x, h2 = fused_rmsnorm(out, x, p["ffn_norm"], eps=cfg.norm_eps)
    if ffn == "dense":
        out = L.ffn_block(p["ffn"], h2, cfg)
        if "ffn_gate" in p:
            out = L.tanh_gate(p, "ffn_gate", out)
        return x, out, pos_cache, 0.0
    out, aux = moe_block(p["ffn"], h2, cfg, return_aux=with_aux)
    return x, out, pos_cache, aux


def _run_group(cfg: ModelConfig, gparams, x, delta, *, positions,
               group_cache, kv_lens, rope, cross_kv, with_aux):
    """The positions of one layer group; returns (x, delta, aux), aux
    summed over the positions in fp32 from 0, as the reference's
    ``_apply_group`` sums it."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if with_aux else 0.0
    for i, (mixer, ffn) in enumerate(cfg.group_pattern):
        key = f"pos{i}"
        pos_cache = None if group_cache is None else group_cache[key]
        x, delta, _, a = _apply_position(
            cfg, mixer, ffn, gparams[key], x, delta, positions=positions,
            pos_cache=pos_cache, kv_lens=kv_lens, rope=rope,
            cross_kv=cross_kv, first=i == 0, with_aux=with_aux)
        aux = aux + a
    return x, delta, aux


def _run_groups(cfg: ModelConfig, params, x, *, positions, cache, kv_lens,
                cross_kv=None, with_aux=False, remat=False):
    """Loop over the stacked group dim; layer g reads the views of group
    g of the stacked params and caches (cache writes land in the stacked
    tensors).  Returns (x, delta, aux): the residual stream and
    the last branch output, which ``_head`` adds as it applies
    ``final_norm``, and the groups' summed MoE loss (0.0 without
    ``with_aux``).  The first layer adds the embeddings to a zero stream,
    so every norm of the model goes through the fused kernel.  With
    ``remat`` each group runs under ``torch.utils.checkpoint``: autograd
    keeps only a group's inputs and runs the group again in the
    backward."""
    rope = (L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.has_attention and cfg.pos_embedding == "rope" else None)
    x, delta = torch.zeros_like(x), x
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if with_aux else 0.0
    # each stacked leaf split once into its groups' views: under autograd
    # the per-group grads are stacked once into the leaf's grad, where a
    # view per group (leaf[g]) would add a leaf-sized zero-filled grad per
    # group (at qwen2.5-3b's full width, 36 of them a leaf)
    groups = map_tree(lambda leaf: leaf.unbind(0), params["groups"])
    for g in range(cfg.num_groups):
        gparams = map_tree(lambda views: views[g], groups)
        group_cache = None
        if cache is not None:
            group_cache = {key: {name: leaf[g] for name, leaf in c.items()}
                           for key, c in cache.items()}
        body = functools.partial(
            _run_group, cfg, gparams, positions=positions,
            group_cache=group_cache, kv_lens=kv_lens, rope=rope,
            cross_kv=cross_kv, with_aux=with_aux)
        if remat:
            x, delta, a = checkpoint(body, x, delta, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            x, delta, a = body(x, delta)
        aux = aux + a
    return x, delta, aux


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params, tokens=None, embeds=None,
                  positions=None):
    """Token ids through the embedding table, or ``embeds`` as given (in
    their own dtype, uncast, as the reference takes them); then gemma's
    scale and the sinusoid at ``positions`` (in fp32, cast to x's
    dtype)."""
    if embeds is not None:
        x = embeds
    else:
        tok = torch.clamp(tokens, 0, cfg.padded_vocab - 1)
        x = F.embedding(tok.long(), params["embed"].to(
            torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32))
    if cfg.scale_embeddings:
        # gemma's sqrt(d_model), rounded to the activations' dtype before
        # the multiply, as the reference does (55.43 is 55.5 in bf16); a
        # host scalar, so a captured decode graph holds no copy
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    if cfg.pos_embedding == "sinusoidal":
        x = x + L.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
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


def _check_cross_kv(cfg: ModelConfig, x, cross_kv):
    """Raise unless a model with cross-attention positions has image
    embeddings of a dtype that keeps the residual stream's."""
    if cross_kv is None and any(m == "cross_attn"
                                for m, _ in cfg.group_pattern):
        raise ValueError(NO_IMAGE_EMBEDDINGS.format(name=cfg.name))
    if cross_kv is not None and \
            torch.promote_types(cross_kv.dtype, x.dtype) != x.dtype:
        # the cross branch would come out in the wider dtype and turn the
        # residual stream to it; the reference's group scan refuses such
        # a carry with a TypeError too
        raise TypeError(
            f"{cfg.name}: cross_kv in {cross_kv.dtype} would change the "
            f"{x.dtype} residual stream's dtype at the cross-attention "
            f"positions")


def forward(cfg: ModelConfig, params, tokens=None, *, embeds=None,
            cross_kv=None, positions=None):
    """Full-sequence logits [B, S, padded_vocab] (training / evaluation)
    and the MoE load-balance loss summed over the layers (an fp32 scalar,
    0 without MoE FFNs); no caches.  The input is token ids ``tokens``
    [B, S] or embeddings ``embeds`` [B, S, d_model], at ``positions`` [B,
    S] (default 0..S-1); a model with cross-attention positions needs
    ``cross_kv`` [B, vision_seq, d_model].  Differentiable: under
    autograd with ``cfg.remat`` each layer group is rematerialised."""
    check_supported(cfg)
    src = tokens if tokens is not None else embeds
    b, s = src.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=src.device).expand(b, s)
    x = _embed_inputs(cfg, params, tokens, embeds, positions)
    _check_cross_kv(cfg, x, cross_kv)
    x, delta, aux = _run_groups(
        cfg, params, x, positions=positions, cache=None, kv_lens=None,
        cross_kv=cross_kv, with_aux=True,
        remat=cfg.remat and torch.is_grad_enabled())
    return _head(cfg, params, x, delta), aux


def prefill(cfg: ModelConfig, params, tokens=None, *, embeds=None,
            cross_kv=None, cache, prompt_lens=None):
    """Run the prompt, fill the caches (in place), return (last-position
    logits [B, vocab], cache).  The prompt is token ids ``tokens`` [B, S]
    or embeddings ``embeds`` [B, S, d_model]; a model with cross-attention
    positions needs ``cross_kv`` [B, vision_seq, d_model], the image
    embeddings its cross-attention reads (a ``ValueError`` without them).
    Only the rows at ``prompt_lens - 1`` go through the head: the head is
    row-wise, so this equals the reference's take-after-head and skips a
    [B, S, vocab] logits tensor."""
    check_supported(cfg)
    src = tokens if tokens is not None else embeds
    b, s = src.shape[:2]
    positions = torch.arange(s, device=src.device).expand(b, s)
    if prompt_lens is None:
        prompt_lens = torch.full((b,), s, dtype=torch.int32,
                                 device=src.device)
    x = _embed_inputs(cfg, params, tokens, embeds, positions)
    _check_cross_kv(cfg, x, cross_kv)
    x, delta, _ = _run_groups(cfg, params, x, positions=positions,
                              cache=cache, kv_lens=prompt_lens,
                              cross_kv=cross_kv)
    last = (prompt_lens.long() - 1).view(b, 1, 1).expand(b, 1, x.shape[-1])
    return _head(cfg, params, torch.gather(x, 1, last),
                 torch.gather(delta, 1, last))[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, kv_lens):
    """One decode step. tokens: [B] int32; kv_lens: [B] current lengths.

    Returns (logits [B, vocab], cache); the cache tensors are updated in
    place (the reference donates them to its jitted step instead).  A
    cross-attention position reads the image K/V its prefill cached."""
    check_supported(cfg)
    positions = kv_lens[:, None]
    x = _embed_inputs(cfg, params, tokens[:, None], positions=positions)
    x, delta, _ = _run_groups(cfg, params, x, positions=positions,
                              cache=cache, kv_lens=kv_lens)
    return _head(cfg, params, x, delta)[:, 0], cache
