"""shard_map'd IQ synthesis over a ('time', 'chan') mesh.

Sharding layout for a DeviceBatch (see ops/plan.py):
  epochs  (B axis)  -> 'time'  : embarrassingly parallel, no collectives
  channels (C axis) -> 'chan'  : each device accumulates its channel slice,
                                 then partial int32 I/Q sums are psum-reduced
                                 (a NCCL all-reduce on GPUs) *before* the
                                 (acc+64)>>7 quantization — matching the
                                 reference, which sums all channels first
                                 (gpssim.c:2192-2259).

Correctness invariants (tested on a virtual 8-device CPU mesh):
  * N-device output == 1-device output, bit-exact, for any (time, chan)
    factorization;
  * epoch padding added to fill the 'time' axis is silent (zero gain) and
    stripped before returning.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gps_sdr_sim_tpu.ops.plan import DeviceBatch, pad_epoch_axis
from gps_sdr_sim_tpu.ops import synth_jnp
from gps_sdr_sim_tpu.parallel.mesh import CHAN_AXIS, TIME_AXIS

# PartitionSpecs per DeviceBatch field (order matches _FIELDS below).
_FIELDS = ("code_s", "code_p", "carr_s", "carr_p", "t_base", "m0", "b0",
           "navbits", "gain", "ca_words")
_IN_SPECS = (
    P(TIME_AXIS, CHAN_AXIS, None),        # code_s  [B, C, 3]
    P(TIME_AXIS, None, CHAN_AXIS, None),  # code_p  [B, SB, C, 3]
    P(TIME_AXIS, CHAN_AXIS, None),        # carr_s  [B, C, 3]
    P(TIME_AXIS, None, CHAN_AXIS, None),  # carr_p  [B, SB, C, 3]
    P(TIME_AXIS, None, CHAN_AXIS),        # t_base  [B, SB, C]
    P(TIME_AXIS, CHAN_AXIS),              # m0      [B, C]
    P(TIME_AXIS, CHAN_AXIS),              # b0      [B, C]
    P(TIME_AXIS, CHAN_AXIS),              # navbits [B, C]
    P(TIME_AXIS, CHAN_AXIS),              # gain    [B, C]
    P(CHAN_AXIS, None),                   # ca_words [C, 32]
)


@lru_cache(maxsize=None)
def _get_sharded_fn(mesh: Mesh, n_out: int, local_chan: int):
    def local_step(code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits,
                   gain, ca_words):
        iacc, qacc = synth_jnp.accumulate(
            code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
            ca_words, n_chan=local_chan)
        # Cross-device channel reduction BEFORE quantization (int32 exact).
        iacc = jax.lax.psum(iacc, CHAN_AXIS)
        qacc = jax.lax.psum(qacc, CHAN_AXIS)
        return synth_jnp.quantize_iq(iacc, qacc, n_out)

    fn = jax.shard_map(
        local_step, mesh=mesh, in_specs=_IN_SPECS,
        out_specs=P(TIME_AXIS, None, None))
    return jax.jit(fn)


def synth_batch_sharded(db: DeviceBatch, n_out: int, mesh: Mesh) -> jax.Array:
    """DeviceBatch -> [B, n_out, 2] int16, sharded over `mesh`."""
    n_time = mesh.shape[TIME_AXIS]
    n_chan_dev = mesh.shape[CHAN_AXIS]
    C = db.gain.shape[1]
    if C % n_chan_dev != 0:
        raise ValueError(f"{C} channels not divisible by mesh "
                         f"'chan' size {n_chan_dev}")
    # Silent (zero-gain) epochs fill the 'time' axis; sliced off below.
    b_valid = db.gain.shape[0]
    db = pad_epoch_axis(db, -(-b_valid // n_time) * n_time)
    fn = _get_sharded_fn(mesh, n_out, C // n_chan_dev)
    out = fn(*(jnp.asarray(getattr(db, f)) for f in _FIELDS))
    return out[:b_valid]
