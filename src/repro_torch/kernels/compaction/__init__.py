"""Elastic bucket compaction: the row-gather kernel and ``fused_compact``,
which gathers the live slots of every cache leaf plus ``kv_lens`` and the
last tokens into a smaller bucket with zero host syncs."""

from repro_torch.kernels.compaction.ops import fused_compact, gather_rows  # noqa: F401
from repro_torch.kernels.compaction.ref import compact_reference  # noqa: F401
