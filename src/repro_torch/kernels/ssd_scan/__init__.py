"""The SSD's chunk-state scan (kernel S8): the state carried from chunk to
chunk in the Mamba2 mixer's chunked SSD (``models.mamba``), and its
gradient (kernel S8b)."""

from repro_torch.kernels.ssd_scan.ops import ssd_state_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_state_scan_bwd_reference,
                                              ssd_state_scan_reference)

__all__ = ["ssd_state_scan", "ssd_state_scan_bwd_reference",
           "ssd_state_scan_reference"]
