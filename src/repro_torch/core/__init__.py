"""SpDISTAL core, the port of the JAX package's ``repro.core``.

Four independent sub-languages (paper §II):
  - computation:  :mod:`.tin`       (tensor index notation)
  - formats:      :mod:`.formats`   (per-level Dense/Compressed/Singleton)
  - distribution: :mod:`.tdn`       (universe/nnz/fused TDN)
  - scheduling:   :mod:`.schedule`  (divide/distribute/communicate)

plus the compilation machinery:
  - :mod:`.partition` — dependent partitioning (image/preimage)
  - :mod:`.lower`     — scheduled TIN → a kernel that runs on the card
  - :mod:`.grid`      — 2-D and 3-D machine grids (tiles, bricks, 2.5-D)
  - :mod:`.interp`    — the dense interpretation oracle
"""
from . import formats, levels
from .formats import (BCSC, BCSR, COO, CSC, CSF, CSR, DCSF, DCSR, DDC,
                      Compressed, Dense, DenseMat, DenseND, DenseVec, Format,
                      Singleton, SparseVec, capabilities, conversion_target,
                      format_key)
from .interp import interpret
from .levels import LevelTree, Walk, tree_of
# The lowering entry point is re-exported as ``lower_stmt`` so that the
# package attribute ``lower`` stays bound to the submodule, as in the
# reference.
from .lower import (AxisComm, CacheStats, CommStats, LoweredKernel,
                    clear_lowering_caches, default_grid_nnz_schedule,
                    default_grid_schedule, default_nnz_schedule,
                    default_row_schedule)
from .lower import lower as lower_stmt
from . import grid
from . import lower
from .partition import (ShardedTensor, TensorPartition, image,
                        partition_by_bounds, partition_tensor_grid,
                        partition_tensor_nonzeros, partition_tensor_rows,
                        preimage, replicate_tensor)
from .schedule import CPUThread, Schedule, TPUGrid, VectorLanes
from .tdn import Distribution, Machine, dist
from .tensor import Tensor, TensorVar
from .tin import Access, Assignment, IndexVar, index_vars, parse_tin

__all__ = [
    "formats", "grid", "levels", "LevelTree", "Walk", "tree_of", "BCSC", "BCSR",
    "COO", "CSC",
    "CSF", "CSR", "DCSF", "DCSR", "DDC", "Compressed", "Dense", "DenseMat",
    "DenseND", "DenseVec", "Format", "Singleton", "SparseVec",
    "capabilities", "conversion_target", "format_key", "interpret", "AxisComm", "CacheStats",
    "CommStats", "LoweredKernel", "clear_lowering_caches",
    "default_grid_nnz_schedule", "default_grid_schedule",
    "default_nnz_schedule", "default_row_schedule", "lower", "lower_stmt",
    "ShardedTensor", "TensorPartition", "image", "partition_by_bounds",
    "partition_tensor_grid", "partition_tensor_nonzeros", "partition_tensor_rows", "preimage",
    "replicate_tensor", "CPUThread", "Schedule", "TPUGrid", "VectorLanes",
    "Distribution", "Machine", "dist", "Tensor", "TensorVar", "Access",
    "Assignment", "IndexVar", "index_vars", "parse_tin",
]
