"""End-to-end simulation runner: scenario -> device batches -> output file.

Replaces the reference's sequential epoch loop (gpssim.c:2154-2353) with a
pipelined producer/consumer: the host prepares fixed-point phase-ramp
batches while the device synthesizes the previous batch asynchronously (JAX
dispatch is async; we only block when fetching bytes for the writer).
Batches are padded to a fixed epoch count so exactly one XLA compilation is
ever needed per (sample-rate, format) pair.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import BinaryIO, Callable, Optional

import numpy as np

from gps_sdr_sim_tpu.models.scenario import Scenario
from gps_sdr_sim_tpu.ops.plan import pad_epoch_axis, plan_batch
from gps_sdr_sim_tpu.ops.quantize import pack
from gps_sdr_sim_tpu.ops import synth_jnp

IMPLS = ("xla", "xla-sharded")


@dataclass
class RunStats:
    total_samples: int = 0
    wall_seconds: float = 0.0
    device_batches: int = 0
    plan_seconds: float = 0.0   # host batch preparation (ops/plan.py)
    fetch_seconds: float = 0.0  # blocked on device->host readback
    write_seconds: float = 0.0  # file writes

    @property
    def samples_per_second(self) -> float:
        return self.total_samples / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self, samp_freq: float) -> dict:
        """Structured run summary (SURVEY.md §5: observability contract),
        naming the device it ran on."""
        import jax

        dev = jax.devices()[0]
        return {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "total_samples": self.total_samples,
            "device_batches": self.device_batches,
            "wall_seconds": round(self.wall_seconds, 3),
            "plan_seconds": round(self.plan_seconds, 3),
            "fetch_seconds": round(self.fetch_seconds, 3),
            "write_seconds": round(self.write_seconds, 3),
            "samples_per_second": round(self.samples_per_second, 1),
            "realtime_factor": round(
                self.samples_per_second / samp_freq, 2) if samp_freq else 0.0,
        }


def iter_segment_batches(segments, lo: int, hi: int, batch_epochs: int):
    """Yield (segment, e0, e1) covering output epochs [lo, hi) in order.

    Output epoch k (0-based) is synthesized by segment-local epoch
    k - (first_epoch - 1) of the segment containing it; segments tile the
    output range contiguously, so any sub-range — a shard for one host, a
    resume after failure — maps to per-segment slices with no overlap.
    `segments` may be any iterable, including the lazy stream from
    models.scenario.build_scenario_streaming (day-scale runs plan each
    30 s segment only when synthesis reaches it).
    """
    for seg in segments:
        s0 = seg.first_epoch - 1
        a, b = max(lo, s0), min(hi, s0 + seg.n_epochs)
        e = a - s0
        while e < b - s0:
            step = min(batch_epochs, (b - s0) - e)
            yield seg, e, e + step
            e += step


def iter_seg_batches(scn: Scenario, lo: int, hi: int, batch_epochs: int):
    """iter_segment_batches over a fully-materialized Scenario."""
    return iter_segment_batches(scn.segments, lo, hi, batch_epochs)


def run_epoch_range(scn: Scenario, fp: BinaryIO, lo: int, hi: int,
                    batch_epochs: int = 20,
                    log: Optional[Callable[[str], None]] = None,
                    impl: str = "xla", queue_depth: int = 4) -> RunStats:
    """Synthesize output epochs [lo, hi) of `scn` into `fp`.

    impl: "xla" (the XLA kernel of ops/synth_jnp.py on the default device)
    or "xla-sharded" (the same kernel sharded over ALL local devices of a
    multi-device host via parallel/shard.py — use --shard-dir/--multihost
    for multi-process scaling instead).

    queue_depth batches stay in flight with device->host copies started
    eagerly (copy_to_host_async), so synthesis, the readback link, and the
    file writes all overlap; the writer drains in order, preserving the
    reference's sequential byte stream.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if log is None:
        log = lambda s: print(s, end="", file=sys.stderr, flush=True)

    synth = synth_jnp.synth_batch
    if impl == "xla-sharded":
        from gps_sdr_sim_tpu.parallel import auto_mesh, synth_batch_sharded

        mesh = auto_mesh()  # time-only mesh over all local devices
        synth = lambda db, n: synth_batch_sharded(db, n, mesh)

    n = scn.iq_buff_size
    fmt = scn.config.data_format
    stats = RunStats()
    t_start = time.time()
    pending = deque()  # (device_array, valid_epochs), oldest first

    def flush(dev, valid):
        t0 = time.time()
        host = np.asarray(dev)  # blocks until device work + copy complete
        t1 = time.time()
        fp.write(np.ascontiguousarray(host[:valid]).data)
        stats.fetch_seconds += t1 - t0
        stats.write_seconds += time.time() - t1

    for seg, e, e1 in iter_seg_batches(scn, lo, hi, batch_epochs):
        t_plan = time.time()
        # Zero-gain (silent) padding to a fixed batch shape: one compile.
        db = pad_epoch_axis(plan_batch(seg, e, e1, n, scn.delt),
                            batch_epochs)
        out = pack(synth(db, n), fmt)
        out.copy_to_host_async()
        stats.plan_seconds += time.time() - t_plan  # host plan + dispatch
        if len(pending) >= queue_depth:
            flush(*pending.popleft())  # timed as fetch/write, not plan
        pending.append((out, e1 - e))
        stats.device_batches += 1
        stats.total_samples += (e1 - e) * n
        t_into = (seg.first_epoch + e1 - 1) * 0.1
        log(f"\rTime into run = {t_into:4.1f}")

    while pending:
        flush(*pending.popleft())

    stats.wall_seconds = time.time() - t_start
    return stats


def run_simulation(scn: Scenario, fp: BinaryIO, batch_epochs: int = 20,
                   log: Optional[Callable[[str], None]] = None,
                   impl: str = "xla", queue_depth: int = 4) -> RunStats:
    """Synthesize the whole scenario into `fp`. Returns throughput stats."""
    return run_epoch_range(scn, fp, 0, scn.n_output_epochs,
                           batch_epochs=batch_epochs, log=log, impl=impl,
                           queue_depth=queue_depth)
