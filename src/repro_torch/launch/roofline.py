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

The reference's HLO accounting (``HloAnalyzer``, ``roofline_report``)
reads XLA's compiled HLO and has no twin here (ROADMAP Queue 1 item 7e).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 67e12        # float32 FLOP/s, CUDA cores, H100 SXM
HBM_BW = 3.35e12          # bytes/s, HBM3, H100 SXM
ICI_BW = 450e9            # bytes/s, NVLink 4, one direction


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
