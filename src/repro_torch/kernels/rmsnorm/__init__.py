from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_reference, rmsnorm_reference

__all__ = ["fused_rmsnorm", "rmsnorm_reference", "rmsnorm_bwd_reference"]
