"""Parallelism layer.

The reference is a single-threaded sequential loop (gpssim.c:2154-2353);
this package is its data-parallel replacement: time-block ("data/sequence
parallel") and channel ("tensor parallel") sharding of the IQ synthesis over
a jax.sharding.Mesh, with a psum of partial channel sums before
quantization, plus per-host ordered shard files with a manifest for
multi-host output and restart/resume.
"""

from gps_sdr_sim_tpu.parallel.mesh import auto_mesh, make_mesh
from gps_sdr_sim_tpu.parallel.shard import synth_batch_sharded
from gps_sdr_sim_tpu.parallel.writer import (
    Manifest,
    concat_shards,
    plan_epoch_shards,
    run_simulation_sharded,
)

__all__ = [
    "auto_mesh",
    "make_mesh",
    "synth_batch_sharded",
    "Manifest",
    "concat_shards",
    "plan_epoch_shards",
    "run_simulation_sharded",
]
