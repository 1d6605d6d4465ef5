from repro_torch.kernels.backlog_scan.ops import MAX_REPLICAS, backlog_scan
from repro_torch.kernels.backlog_scan.ref import backlog_scan_reference

__all__ = ["MAX_REPLICAS", "backlog_scan", "backlog_scan_reference"]
