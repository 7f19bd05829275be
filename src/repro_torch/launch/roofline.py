"""Roofline constants of the card and the time formulas over them.

The port of the JAX package's ``launch/roofline.py::HardwareModel``: the
plan-time cost model of :mod:`repro_torch.core.plan_search` scores
candidate schedules with it before any kernel runs. ``DEFAULT_HW`` holds
the datasheet figures of one NVIDIA H100 SXM (80 GB HBM3, 700 W):

- ``peak_flops`` 67 TFLOP/s, float32 on the CUDA cores: the sparse
  operands' values and the sparse kernels are float32 and do not use the
  tensor cores;
- ``hbm_bw`` 3.35 TB/s of HBM3;
- ``ici_bw`` 450 GB/s, one direction of NVLink 4 (900 GB/s both ways),
  the link the pieces of a multi-card machine exchange bytes over.

``LM_HW`` is the same card for the language models' steps, whose
matrix products run in bf16 on the tensor cores: 989 TFLOP/s dense
bf16, with the same HBM and link figures. The dry-run's roofline
(:func:`roofline_report`) scores with it; ``DEFAULT_HW`` stays what the
autoscheduler scores with.

**The step's cost is counted, not read from HLO.** The reference reads
its per-device terms from XLA's compiled SPMD module (``HloAnalyzer``).
PyTorch compiles no such module, so ``HloAnalyzer`` has no twin here.
Instead one rank's step runs eagerly on ``meta`` tensors
(:mod:`.dryrun`) under three counters:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products
  and attention; elementwise work is not counted, as the reference counts
  only ``dot`` ops);
- HBM bytes: :class:`ByteCounter`, each op's input and output bytes
  summed (views move nothing and are left out). With no fusion between
  eager ops this is an upper bound on the step's HBM traffic;
- collective bytes: ``distributed.collectives.TRAFFIC_BY_KIND``, the
  bytes a rank receives, which the gathers count on a layout mesh as they
  would on a real one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 67e12        # float32 FLOP/s, CUDA cores, H100 SXM
HBM_BW = 3.35e12          # bytes/s, HBM3, H100 SXM
ICI_BW = 450e9            # bytes/s, NVLink 4, one direction
BF16_PEAK_FLOPS = 989e12  # dense bf16 FLOP/s, tensor cores, H100 SXM


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Roofline hardware constants bundled with the time formulas (the
    reference's field names: ``ici_bw`` is the inter-card link)."""

    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW

    def compute_s(self, flops: float) -> float:
        return flops / self.peak_flops

    def memory_s(self, nbytes: float) -> float:
        return nbytes / self.hbm_bw

    def collective_s(self, nbytes: float) -> float:
        return nbytes / self.ici_bw

    def bound_s(self, flops: float, mem_bytes: float,
                coll_bytes: float) -> float:
        """Roofline bound: on-chip terms overlap (max), network adds."""
        return max(self.compute_s(flops), self.memory_s(mem_bytes)) \
            + self.collective_s(coll_bytes)


DEFAULT_HW = HardwareModel()

#: the language models' steps: bf16 matrix products on the tensor cores
LM_HW = HardwareModel(peak_flops=BF16_PEAK_FLOPS)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Sums the bytes every op reads and writes (its tensor inputs and
    outputs), views and ops on no tensor left out: an upper bound on HBM
    traffic, since eager ops share nothing through registers or caches."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.nbytes += sum(
                _nbytes(t) for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def roofline_report(flops: float, mem_bytes: float,
                    coll_bytes: Dict[str, float], *,
                    model_flops_per_device: float = 0.0,
                    hw: HardwareModel = LM_HW) -> Dict:
    """Per-device roofline terms of one rank's counted step: the
    reference's keys, with ``flops_per_dev``, ``mem_bytes_per_dev`` and
    ``coll_bytes_per_dev`` (by kind) in place of its three ``hlo_*``
    ones."""
    compute_t = hw.compute_s(flops)
    memory_t = hw.memory_s(mem_bytes)
    coll_t = hw.collective_s(sum(coll_bytes.values()))
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    dominant = max(terms, key=terms.get)
    bound = max(compute_t, memory_t, coll_t)
    out = {
        "flops_per_dev": flops,
        "mem_bytes_per_dev": mem_bytes,
        "coll_bytes_per_dev": dict(coll_bytes),
        **terms,
        "dominant": dominant,
        "roofline_bound_s": bound,
        "compute_fraction_at_bound": (compute_t / bound) if bound else 0.0,
    }
    if model_flops_per_device:
        out["model_flops_per_dev"] = model_flops_per_device
        out["useful_flops_ratio"] = (model_flops_per_device / flops
                                     if flops else 0.0)
    return out
