from repro_torch.kernels.srpt_scan.ops import srpt_scan
from repro_torch.kernels.srpt_scan.ref import srpt_scan_reference

__all__ = ["srpt_scan", "srpt_scan_reference"]
