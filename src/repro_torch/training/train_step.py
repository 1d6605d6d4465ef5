"""Training step: loss, gradient accumulation over microbatches, AdamW
update, the counterpart of ``repro.training.train_step``.

The reference lowers one pure function with pjit and accumulates its
microbatches in a ``lax.scan``; here the step is eager PyTorch on one
device: ``torch.autograd.grad`` of the loss for each microbatch (a Python
loop), the sum in ``grad_accum_dtype``, then ``adamw_update`` in place.
On CUDA the forward's attention and norms run the hand-written kernels
K3 and K4, and their gradients the backward kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward
from repro_torch.models.params import torch_dtype
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 1e-4
    grad_accum_dtype: str = "float32"
    label_pad_id: int = -1


def cross_entropy(logits, labels, pad_id: int = -1):
    """Masked token-mean CE and the z-loss term (fp32): (ce, mean logz^2)
    over the tokens whose label is not ``pad_id``."""
    logits = logits.float()
    mask = labels != pad_id
    safe_labels = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    ce = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    return ce.sum() / denom, (logz ** 2 * mask).sum() / denom


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (loss, {"ce", "aux"}); ``batch`` holds
    ``labels`` and ``tokens`` or ``embeds``, and ``image_embeds`` for a
    model with cross-attention positions."""
    def loss_fn(params, batch):
        logits, aux = forward(cfg, params, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"),
                              cross_kv=batch.get("image_embeds"))
        ce, z2 = cross_entropy(logits, batch["labels"], tcfg.label_pad_id)
        loss = ce + tcfg.z_loss_coef * z2 + tcfg.aux_loss_coef * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """grad_fn(params, batch) -> (grads, {"ce", "aux"}): the loss's
    gradient with respect to every leaf of ``params`` (a tree of the same
    structure), as ``jax.grad(loss_fn, has_aux=True)``.  The params are
    differentiated through detached aliases, so the caller's tensors keep
    their ``requires_grad``."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def grad_fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, aux = loss_fn(live, batch)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets zeros, as from jax.grad
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        aux = {k: torch.as_tensor(v).detach() for k, v in aux.items()}
        return tree_unflatten(params, grads), aux
    return grad_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); params and moments are updated in place.  With
    ``cfg.num_microbatches`` m > 1 the batch splits into m microbatches of
    consecutive rows; their grads are summed in ``tcfg.grad_accum_dtype``
    and divided by m, their ce and aux averaged.  metrics: ``ce``,
    ``aux``, ``grad_norm``, ``lr`` and ``loss`` (= ce), 0-d tensors."""
    grad_fn = make_grad_fn(cfg, tcfg)
    m = cfg.num_microbatches
    acc_dtype = torch_dtype(tcfg.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        if m > 1:
            mb = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                   device=p.device), params)
            auxes = []
            for i in range(m):
                g, aux = grad_fn(params, {k: v[i] for k, v in mb.items()})
                for a, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(gi.to(a.dtype))
                del g
                auxes.append(aux)
            for a in tree_leaves(grads):
                a.div_(m)
            metrics_in = {k: torch.stack([a[k] for a in auxes]).mean()
                          for k in auxes[0]}
        else:
            grads, metrics_in = grad_fn(params, batch)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, tcfg.adamw)
        metrics = dict(metrics_in)
        metrics.update(opt_metrics)
        metrics["loss"] = metrics_in["ce"]
        return params, opt_state, metrics

    return train_step


def train_input_specs(cfg: ModelConfig, global_batch: int, seq_len: int):
    """Shapes and dtypes of one training batch: {name: (shape, dtype)}."""
    specs = {"labels": ((global_batch, seq_len), torch.int32)}
    if cfg.embeddings_input:
        specs["embeds"] = ((global_batch, seq_len, cfg.d_model),
                           torch.bfloat16)
    else:
        specs["tokens"] = ((global_batch, seq_len), torch.int32)
    if cfg.vision_seq:
        specs["image_embeds"] = ((global_batch, cfg.vision_seq, cfg.d_model),
                                 torch.bfloat16)
    return specs
