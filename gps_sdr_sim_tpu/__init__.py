"""gps-sdr-sim-tpu: a GPS L1 C/A baseband signal synthesizer in JAX.

A from-scratch rebuild of the capabilities of gps-sdr-sim (reference:
gpssim.c/gpssim.h) for data-parallel accelerators (an NVIDIA GPU):

 - Host layer (NumPy float64): RINEX navigation parsing, GPS time/geodesy,
   broadcast-ephemeris orbit propagation, pseudorange/Doppler observables,
   Klobuchar ionosphere, navigation-message bit generation, channel
   allocation.  This is the precision-critical scalar logic (~0% of runtime).
 - Device layer (JAX/XLA): the per-sample IQ synthesis hot loop,
   reformulated from the reference's sequential per-sample NCO
   (gpssim.c:2190-2264) into a closed-form, exactly-evaluated fixed-point
   phase ramp over [channels x subblocks x samples], so the whole signal is
   data-parallel and shardable over a device mesh.
 - Parallel layer: time-block ("data parallel") and channel ("tensor
   parallel") sharding via jax.sharding.Mesh + shard_map, with a psum
   before quantization.
"""

__version__ = "0.1.0"

from gps_sdr_sim_tpu import constants  # noqa: F401
