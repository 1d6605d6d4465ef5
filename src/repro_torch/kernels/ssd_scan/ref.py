"""Plain PyTorch version of the SSD's inter-chunk state recurrence (kernel
S8): the reference's ``lax.scan`` over chunks in
``repro.models.mamba._ssd_chunked`` as a Python loop over C, step for step
as its ``step``.  The wrapper runs it for CPU tensors; the tests and
``chip_smoke.py`` hold the kernel against it bit for bit on the card.

Each step is a multiply, then an add, each rounded on its own (two
PyTorch ops), which is what the kernel computes with ``__fmul_rn`` and
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
