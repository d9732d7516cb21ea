"""Join the cost model's reports (``analysis.costmodel.CostReport``) with
measured wall-clock: the reference package's ``obs/attribution.py`` over
the port's cost model, with the H100's datasheet figures as defaults.

The cost model says what a program MUST do (flops, HBM bytes, wire bytes);
a measured per-call time says what it DID.  The join yields:

- **MFU**: achieved flops/s over the bf16 peak (per card: a report counts
  one rank's step, so ``flops / measured_s`` is already per card), always
  against the bf16 peak, whatever ``peak_flops`` is.
- **Roofline side**: whether the analytic compute time (against
  ``peak_flops``) or the analytic HBM time dominates, and the utilization
  ceiling that side imposes.  A caller that attributes an f32 program
  passes ``peak_flops=H100_F32_PEAK_FLOPS``, so both name the side the card
  really hits.
- **Comm/compute ratio**: serial wire seconds (over NVLink) per compute
  second.
- **Exposed-comm bound** for the ``overlap`` strategy: at most the LARGEST
  collective is exposed; ``ddp``'s chained plan pays the full sum.
- **HBM residency**: given any object with ``peak_bytes`` (a measured
  ``torch.cuda.max_memory_allocated``), the peak and its headroom against
  the card's capacity.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..analysis.costmodel import (CostReport, H100_BF16_PEAK_FLOPS,
                                  H100_HBM_BYTES_PER_S,
                                  H100_HBM_CAPACITY_BYTES,
                                  H100_NVLINK_BYTES_PER_S, mfu_fields)

__all__ = ["attribute", "overlap_vs_ddp", "mfu_fields"]


def attribute(report: CostReport, *, measured_s: Optional[float] = None,
              mem_report=None,
              peak_flops: float = H100_BF16_PEAK_FLOPS,
              bf16_peak_flops: float = H100_BF16_PEAK_FLOPS,
              hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S,
              hbm_capacity_bytes: int = H100_HBM_CAPACITY_BYTES,
              ici_bytes_per_s: float = H100_NVLINK_BYTES_PER_S) -> Dict:
    """Attribution record for one program; ``measured_s`` (seconds a call,
    the report's per-rank scope) adds the measured-join fields, otherwise
    the record is purely analytic.  ``mem_report`` (anything with
    ``peak_bytes`` for the SAME program) adds the peak-residency fields.
    ``ici_bytes_per_s`` is the interconnect's rate a direction (the
    reference's name; NVLink here)."""
    compute_s = report.flops / peak_flops
    hbm_s = report.hbm_bytes / hbm_bytes_per_s
    comm_s = report.wire_bytes / ici_bytes_per_s
    denom = max(compute_s, hbm_s)
    out = {
        "program": report.name,
        "gflops": round(report.flops / 1e9, 4),
        "hbm_mib": round(report.hbm_bytes / 2**20, 3),
        "wire_mib": round(report.wire_bytes / 2**20, 4),
        "analytic_compute_s": compute_s,
        "analytic_hbm_s": hbm_s,
        "analytic_comm_s": comm_s,
        "roofline_bound": "compute" if compute_s >= hbm_s else "bandwidth",
        # The MFU ceiling the dominant roofline side permits: 1.0 when
        # compute-bound, compute_s/hbm_s when the HBM wall caps it.
        "mfu_roofline_ceiling": round(compute_s / denom, 4) if denom else None,
        "comm_compute_ratio": (round(comm_s / compute_s, 4)
                               if compute_s else None),
        "arithmetic_intensity": (round(report.arithmetic_intensity, 2)
                                 if report.hbm_bytes else None),
    }
    if measured_s:
        achieved = report.flops / measured_s
        out["measured_s"] = round(measured_s, 6)
        out["achieved_tflops_per_sec"] = round(achieved / 1e12, 4)
        out["mfu_vs_bf16_peak"] = round(achieved / bf16_peak_flops, 6)
    if mem_report is not None:
        peak = int(mem_report.peak_bytes)
        out["peak_hbm_mib"] = round(peak / 2**20, 3)
        out["hbm_headroom_mib"] = round(
            (hbm_capacity_bytes - peak) / 2**20, 3)
        out["hbm_capacity_utilization"] = round(
            peak / hbm_capacity_bytes, 6) if hbm_capacity_bytes else None
    return out


def overlap_vs_ddp(overlap_report: CostReport, ddp_report: CostReport, *,
                   ici_bytes_per_s: float = H100_NVLINK_BYTES_PER_S) -> Dict:
    """Exposed-comm upper bound of the un-chained ``overlap`` plan vs the
    serial cost of ``ddp``'s chained bucket plan (per step: the
    per-collective sizes of one counted step)."""
    exposed = (max(overlap_report.collective_sizes)
               if overlap_report.collective_sizes else 0)
    chained = sum(ddp_report.collective_sizes)
    exposed_s = exposed / ici_bytes_per_s
    chained_s = chained / ici_bytes_per_s
    return {
        "overlap_exposed_bytes_upper_bound": exposed,
        "ddp_chained_bytes": chained,
        "overlap_exposed_comm_s_upper_bound": exposed_s,
        "ddp_chained_comm_s": chained_s,
        "hiding_ratio_lower_bound": (round(chained_s / exposed_s, 2)
                                     if exposed_s else None),
    }
