"""Interpretation baseline — the CTF analog (paper §I, §VI).

CTF executes a tensor algebra expression as a *series of pairwise*
distributed matmul / elementwise / transposition operations, materializing
dense(ish) intermediates between steps. The paper shows this costs 1–2
orders of magnitude vs. SpDISTAL's fused compiled kernels (Fig. 10:
299× SpMV, 161× SpTTV, 19.2× SpAdd3, 15.3× SDDMM).

This module reproduces that execution model faithfully enough to measure the
same effect: each multiplication is reduced to a pairwise contraction over
*densified* operands with materialized intermediates (including the
asymptotic blowup for expressions needing fusion, e.g. SDDMM materializes
the full C·D product); additions are executed pairwise with intermediate
assembly. No fusion, no format specialization — exactly what compilation
buys in the paper.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .device import resolve_device
from .tin import Access, Add, Assignment, Literal, Mul, TinExpr
from .tensor import Tensor


def _densify(acc: Access, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(acc.tensor.to_dense(), device=device)


def _flatten_mul(e: TinExpr) -> List[Access]:
    if isinstance(e, Mul):
        return _flatten_mul(e.lhs) + _flatten_mul(e.rhs)
    if isinstance(e, Access):
        return [e]
    raise NotImplementedError(type(e))


def _flatten_add(e: TinExpr) -> List[TinExpr]:
    if isinstance(e, Add):
        return _flatten_add(e.lhs) + _flatten_add(e.rhs)
    return [e]


def interpret(stmt: Assignment, device=None) -> np.ndarray:
    """Execute ``stmt`` CTF-style on ``device`` (the card when None).
    Returns the dense result as numpy.

    Pairwise contraction order is chosen greedily to minimize each
    materialized intermediate (CTF also plans pair orders); the
    characteristic interpretation costs remain — every intermediate is a
    DENSE materialized tensor and execution is step-by-step. E.g. SDDMM
    materializes the full dense C·D product (the asymptotic cost the paper
    describes in §VI-A), instead of the even-worse 3-D outer product a
    naive left-to-right order would produce."""
    device = resolve_device(device)
    out_idx = [v.name for v in stmt.lhs.idx]
    terms = _flatten_add(stmt.rhs)
    result = None
    for term in terms:
        accs = _flatten_mul(term)
        dims: dict = {}
        for a in accs:
            for v, s in zip(a.idx, a.tensor.shape):
                dims[v.name] = s
        remaining = list(accs)
        # choose the starting factor that admits the smallest first
        # intermediate (CTF plans the contraction tree, not just the order)
        if len(remaining) > 1:
            cand = list(remaining)  # list.sort() empties the list mid-sort

            def start_cost(a):
                a_idx = [v.name for v in a.idx]
                best = None
                for b in cand:
                    if b is a:
                        continue
                    later = set(out_idx)
                    for rest in cand:
                        if rest is not a and rest is not b:
                            later.update(v.name for v in rest.idx)
                    keep = [i for i in dict.fromkeys(
                        a_idx + [v.name for v in b.idx]) if i in later]
                    n = 1
                    for i in keep:
                        n *= dims[i]
                    best = n if best is None else min(best, n)
                return best if best is not None else float("inf")

            remaining.sort(key=start_cost)
        first = remaining.pop(0)
        cur = _densify(first, device)
        cur_idx = [v.name for v in first.idx]
        while remaining:
            # greedy: pick the factor whose pairwise intermediate is
            # smallest
            def inter_size(acc):
                nxt_idx = [v.name for v in acc.idx]
                later = set(out_idx)
                for rest in remaining:
                    if rest is not acc:
                        later.update(v.name for v in rest.idx)
                keep = [i for i in dict.fromkeys(cur_idx + nxt_idx)
                        if i in later]
                n = 1
                for i in keep:
                    n *= dims[i]
                return n, keep

            best = min(remaining, key=lambda a: inter_size(a)[0])
            _, keep = inter_size(best)
            remaining.remove(best)
            nxt_arr = _densify(best, device)
            nxt_idx = [v.name for v in best.idx]
            spec = f"{''.join(cur_idx)},{''.join(nxt_idx)}->{''.join(keep)}"
            cur = torch.einsum(spec, cur, nxt_arr)  # materialized intermediate
            cur_idx = keep
        if cur_idx != out_idx:
            spec = f"{''.join(cur_idx)}->{''.join(out_idx)}"
            cur = torch.einsum(spec, cur)
        result = cur if result is None else result + cur
    return result.cpu().numpy()
