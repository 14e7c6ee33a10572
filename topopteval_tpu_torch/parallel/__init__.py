"""Batched design sweeps (counterpart of ``topopteval_tpu.parallel``; its
multi-device half, ``shard_sweep_inputs`` and the sharded operators, is
ROADMAP Queue A item 13)."""

from .sweep import (SweepKernel, simp_scales, sweep_compliance,
                    sweep_compliance_pairs)

__all__ = ["SweepKernel", "simp_scales", "sweep_compliance",
           "sweep_compliance_pairs"]
