from repro_torch.kernels.impatience_scan.ops import impatience_scan
from repro_torch.kernels.impatience_scan.ref import impatience_scan_reference

__all__ = ["impatience_scan", "impatience_scan_reference"]
