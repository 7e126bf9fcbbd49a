"""Device-mesh construction for sharded IQ synthesis.

Axes:
  'time' — time-block parallelism: independent 0.1 s epochs (the reference's
           sequential iumd loop, gpssim.c:2154) sharded as pure data
           parallelism; no collectives needed because phase state is
           propagated analytically on the host (models/scenario.py).
  'chan' — channel parallelism: the per-channel sum (gpssim.c:2195-2209)
           split across devices; partial int32 accumulators are psum-reduced
           before quantization (see parallel/shard.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from gps_sdr_sim_tpu.constants import MAX_CHAN

TIME_AXIS = "time"
CHAN_AXIS = "chan"


def make_mesh(n_time: int, n_chan: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build an (n_time, n_chan) mesh over the first n_time*n_chan devices.

    The cards of one host are joined all to all (NVLink), so any device
    order serves: the shape follows the algorithm alone. Only the psum over
    'chan' communicates (a NCCL all-reduce); 'time' needs no collectives.
    """
    if devices is None:
        devices = jax.devices()
    need = n_time * n_chan
    if len(devices) < need:
        raise ValueError(
            f"mesh ({n_time}x{n_chan}) needs {need} devices, "
            f"have {len(devices)}")
    if MAX_CHAN % n_chan != 0:
        raise ValueError(f"n_chan={n_chan} must divide MAX_CHAN={MAX_CHAN}")
    grid = np.asarray(devices[:need], dtype=object).reshape(n_time, n_chan)
    return Mesh(grid, (TIME_AXIS, CHAN_AXIS))


def auto_mesh(n_devices: Optional[int] = None, n_chan: int = 1) -> Mesh:
    """Mesh over all (or the first n_devices) local devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % n_chan != 0:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"n_chan={n_chan}")
    return make_mesh(n_devices // n_chan, n_chan, devices[:n_devices])
