from repro_torch.distributed.collectives import compressed_mean_rows
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    FSDP_RULES,
    SEQPAR_RULES,
    SWEEP_RULES,
    AxisRules,
    CellsMesh,
    cells_mesh,
    logical_to_spec,
)

__all__ = [
    "AxisRules",
    "CellsMesh",
    "DEFAULT_RULES",
    "FSDP_RULES",
    "SEQPAR_RULES",
    "SWEEP_RULES",
    "cells_mesh",
    "compressed_mean_rows",
    "logical_to_spec",
]
