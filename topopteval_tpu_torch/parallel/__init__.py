"""Multi-device solves and batched design sweeps (counterpart of
``topopteval_tpu.parallel``): device grids and the element-sharded
operator (sharding.py), the halo-exchange operator and the sharded
multigrid behind ``solve_system(devices=...)`` (halo.py, halo_mg.py, on
the collectives of collectives.py), and the sweep lanes (sweep.py)."""

from .halo import HaloShardedOperator
from .sharding import (DATA_AXIS, ELEM_AXIS, DeviceMesh,
                       ShardedStiffnessOperator, build_device_mesh)
from .sweep import (SweepKernel, shard_sweep_inputs, simp_scales,
                    sweep_compliance, sweep_compliance_pairs)

__all__ = ["DATA_AXIS", "ELEM_AXIS", "DeviceMesh", "HaloShardedOperator",
           "ShardedStiffnessOperator", "build_device_mesh", "SweepKernel",
           "shard_sweep_inputs", "simp_scales", "sweep_compliance",
           "sweep_compliance_pairs"]
