from repro_torch.kernels.batch_scan.ops import batch_scan
from repro_torch.kernels.batch_scan.ref import NO_CAP, batch_scan_reference

__all__ = ["NO_CAP", "batch_scan", "batch_scan_reference"]
