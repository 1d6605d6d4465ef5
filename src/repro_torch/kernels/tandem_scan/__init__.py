from repro_torch.kernels.tandem_scan.ops import tandem_scan
from repro_torch.kernels.tandem_scan.ref import tandem_scan_reference

__all__ = ["tandem_scan", "tandem_scan_reference"]
