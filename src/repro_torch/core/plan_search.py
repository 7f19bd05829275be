"""Statement-level communication predictors of the autoscheduler.

Two helpers of the JAX package's ``core/plan_search.py``: which operands a
1-D schedule replicates, derived from the statement alone. The byte-ledger
verifier (:func:`repro_torch.runtime.telemetry.verify_byte_ledger`) reads
them. The rest of the module — candidate enumeration, the cost model and
the tuned-plan cache behind ``schedule="auto"`` — is ROADMAP Queue 1
item 7.
"""
from __future__ import annotations

from typing import List, Tuple

from . import lower as lower_mod
from .tensor import Tensor
from .tin import Assignment


def _replicated_universe(stmt: Assignment) -> List[Tensor]:
    """Operands a 1-D rows schedule replicates — mirrors
    ``_compute_plans``: everything not indexed by the distributed
    variable at (or through) its storage root."""
    dist_var = stmt.result_vars[0]
    out_name = stmt.lhs.tensor.name
    rep: List[Tensor] = []
    seen = set()
    for acc in stmt.accesses():
        t = acc.tensor
        if t.name in seen or t.name == out_name:
            continue
        seen.add(t.name)
        if dist_var in acc.idx:
            lvl_dim = acc.idx.index(dist_var)
            if t.format.level_of_dim(lvl_dim) == 0:
                continue
            if lvl_dim == 0 and t.format.is_sparse:
                continue   # transpose walk realizes the row windows
        rep.append(t)
    return rep


def _replicated_nnz(stmt: Assignment) -> Tuple[List[Tensor], bool]:
    """(replicated operands, output_partitioned) under the 1-D nnz
    schedule: everything but the position-space tensor replicates; a
    dense output whose leading variable is the position tensor's root
    variable is row-partitioned (small boundary-overlap reduce), any
    other output reduces at full extent."""
    pos_t = None
    for acc in stmt.rhs.accesses():
        if acc.tensor.format.is_sparse:
            pos_t = acc.tensor
            break
    out = stmt.lhs.tensor
    rep: List[Tensor] = []
    seen = set()
    for acc in stmt.rhs.accesses():
        t = acc.tensor
        if t.name in seen or (pos_t is not None and t.name == pos_t.name) \
                or t.name == out.name:
            continue
        seen.add(t.name)
        rep.append(t)
    out_partitioned = (
        pos_t is not None and not out.format.is_sparse and bool(stmt.lhs.idx)
        and stmt.lhs.idx[0] == lower_mod.pos_tensor_root_var(stmt, pos_t))
    return rep, out_partitioned
