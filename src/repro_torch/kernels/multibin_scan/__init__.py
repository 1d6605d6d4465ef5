from repro_torch.kernels.multibin_scan.ops import MAX_BINS, multibin_scan
from repro_torch.kernels.multibin_scan.ref import multibin_scan_reference

__all__ = ["MAX_BINS", "multibin_scan", "multibin_scan_reference"]
