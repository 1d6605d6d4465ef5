"""Plain PyTorch versions of the SSD's inter-chunk state recurrence (kernel
S8) and of its gradient (kernel S8b).

``ssd_state_scan_reference`` is the reference's ``lax.scan`` over chunks in
``repro.models.mamba._ssd_chunked`` as a Python loop over C, step for step
as its ``step``.  ``ssd_state_scan_bwd_reference`` is the gradient that
``jax.grad`` takes through that scan, written out as the reverse
recurrence the backward kernel walks.  The wrapper runs them for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernels against them on
the card.

Each step is a multiply, then an add, each rounded on its own (two
PyTorch ops), which is what the kernels compute with ``__fmul_rn`` and
``__fadd_rn``."""

from __future__ import annotations

import torch


def ssd_state_scan_reference(chunk_decay, states, h0=None):
    """chunk_decay [B, C, H], states [B, C, H, P, N], h0 [B, H, P, N] or
    None (zeros), all fp32.  Returns (h_before [B, C, H, P, N], the state
    before each chunk; hT [B, H, P, N], the state after the last):
    ``h_c = h_{c-1} * chunk_decay[:, c] + states[:, c]``."""
    b, c = states.shape[:2]
    h = torch.zeros_like(states[:, 0]) if h0 is None else h0
    h_before = torch.empty_like(states)
    for i in range(c):
        h_before[:, i] = h
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    return h_before, h


def ssd_state_scan_bwd_reference(chunk_decay, h_before, g_h_before, g_hT,
                                 has_h0):
    """The gradient of ``ssd_state_scan_reference`` for the upstream grads
    ``g_h_before`` [B, C, H, P, N] and ``g_hT`` [B, H, P, N] (None:
    zeros), given its inputs' ``chunk_decay`` and its output ``h_before``.
    Returns (g_decay [B, C, H], g_states [B, C, H, P, N], g_h0 [B, H, P, N]
    or None when ``has_h0`` is false).  With G the grad of the carried
    state, from g_hT, for c = C-1 down to 0:
    ``g_states[:, c] = G``, ``g_decay[:, c] = sum(G * h_before[:, c])``
    over (P, N), ``G = G * chunk_decay[:, c] + g_h_before[:, c]``;
    g_h0 is the last G."""
    c = h_before.shape[1]
    g = torch.zeros_like(h_before[:, 0]) if g_hT is None else g_hT
    g_states = torch.empty_like(h_before)
    g_decay = torch.empty_like(chunk_decay)
    for i in reversed(range(c)):
        g_states[:, i] = g
        g_decay[:, i] = (g * h_before[:, i]).sum((-2, -1))
        g = g * chunk_decay[:, i, :, None, None] + g_h_before[:, i]
    return g_decay, g_states, (g if has_h0 else None)
