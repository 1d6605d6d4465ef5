from repro_torch.kernels.wait_scan.ops import wait_scan
from repro_torch.kernels.wait_scan.ref import wait_scan_reference

__all__ = ["wait_scan", "wait_scan_reference"]
