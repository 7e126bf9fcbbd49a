"""Multi-host sharded output: per-host ordered shard files + manifest.

The reference streams one file sequentially (gpssim.c:2101-2111,2266-2288).
Across hosts the sample stream is written as N contiguous time-shards, one
file per shard, described by a JSON manifest. Because every epoch is
independently recomputable from the scenario config (models/scenario.py),
the manifest doubles as the checkpoint: failure recovery = regenerate the
missing/short shards (`resume=True`), and `concat_shards` assembles the
final byte-identical gpssim.bin.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import List, Optional

import jax
import numpy as np

from gps_sdr_sim_tpu.models.scenario import Scenario
from gps_sdr_sim_tpu.runner import RunStats, run_epoch_range


def scenario_hash(scn: Scenario) -> str:
    """Identity stamp of everything that determines the output bytes.

    Input files are hashed by content, so a resume into a shard directory
    produced from different inputs (even ones yielding the same
    bytes-per-epoch) is refused instead of silently concatenated.
    """
    cfg = scn.config
    h = hashlib.sha256()

    def add(x):
        h.update(repr(x).encode())
        h.update(b"\0")

    for p in (cfg.nav_file, cfg.motion_file, cfg.nmea_file):
        if p:
            with open(p, "rb") as fp:
                h.update(hashlib.sha256(fp.read()).digest())
        h.update(b"\0")
    add(cfg.samp_freq)
    add(cfg.data_format)
    add(None if cfg.static_xyz is None
        else tuple(np.asarray(cfg.static_xyz, dtype=float).tolist()))
    add(cfg.duration)
    t0 = scn.t0
    add((t0.y, t0.m, t0.d, t0.hh, t0.mm, t0.sec, scn.g0.week, scn.g0.sec))
    add(cfg.timeoverwrite)
    add(cfg.iono_enable)
    add(cfg.max_motion_points)
    add(cfg.carrier_phase_mode)
    return h.hexdigest()[:16]


def bytes_per_epoch(iq_buff_size: int, data_format: int) -> int:
    """Output bytes per 0.1 s epoch for each sample format (ops/quantize.py)."""
    if data_format == 16:
        return iq_buff_size * 4
    if data_format == 8:
        return iq_buff_size * 2
    if data_format == 1:
        return iq_buff_size // 4
    raise ValueError(f"Invalid I/Q data format: {data_format}")


@dataclass
class ShardEntry:
    index: int
    path: str  # relative to the manifest directory
    first_epoch: int
    n_epochs: int
    n_bytes: int


@dataclass
class Manifest:
    samp_freq: float
    data_format: int
    iq_buff_size: int
    total_epochs: int
    scenario: str = ""  # scenario_hash() stamp; "" in legacy manifests
    shards: List[ShardEntry] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {**{k: v for k, v in asdict(self).items() if k != "shards"},
             "shards": [asdict(s) for s in self.shards]}, indent=1)

    @staticmethod
    def from_json(text: str) -> "Manifest":
        d = json.loads(text)
        shards = [ShardEntry(**s) for s in d.pop("shards")]
        return Manifest(shards=shards, **d)

    def save(self, path: str):
        with open(path, "w") as fp:
            fp.write(self.to_json())

    @staticmethod
    def load(path: str) -> "Manifest":
        with open(path) as fp:
            return Manifest.from_json(fp.read())


def plan_epoch_shards(total_epochs: int, n_shards: int):
    """Split [0, total_epochs) into n_shards near-equal contiguous ranges."""
    base, rem = divmod(total_epochs, n_shards)
    out, lo = [], 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def run_simulation_sharded(scn: Scenario, out_dir: str,
                           n_shards: Optional[int] = None,
                           batch_epochs: int = 20, impl: str = "xla",
                           resume: bool = False,
                           log=None) -> "tuple[Manifest, RunStats]":
    """Write scenario output as time-shards under `out_dir` + manifest.json.

    In a multi-host run (jax.distributed initialized), host h writes shards
    h, h+P, h+2P, ... — each host a disjoint, contiguous-slice writer; no
    cross-host communication is needed because epochs are independent. With
    `resume=True`, shards whose file already has the expected size are
    skipped (restart-after-failure = re-run the same command) — but only
    when the directory's manifest carries the same scenario-identity hash;
    a stale directory from different inputs is refused.

    Returns (manifest, stats) with stats aggregated over the shards this
    process generated.
    """
    os.makedirs(out_dir, exist_ok=True)
    total = scn.n_output_epochs
    if n_shards is None:
        n_shards = max(jax.process_count(), 1)
    ranges = plan_epoch_shards(total, n_shards)
    bpe = bytes_per_epoch(scn.iq_buff_size, scn.config.data_format)
    stamp = scenario_hash(scn)

    manifest_path = os.path.join(out_dir, "manifest.json")
    if resume and os.path.exists(manifest_path):
        prev = Manifest.load(manifest_path)
        if prev.scenario and prev.scenario != stamp:
            raise ValueError(
                f"refusing to resume into {out_dir}: its manifest was "
                f"written for a different scenario (hash {prev.scenario}, "
                f"this run is {stamp})")

    manifest = Manifest(
        samp_freq=scn.samp_freq, data_format=scn.config.data_format,
        iq_buff_size=scn.iq_buff_size, total_epochs=total, scenario=stamp)
    for i, (lo, hi) in enumerate(ranges):
        manifest.shards.append(ShardEntry(
            index=i, path=f"shard_{i:05d}.bin", first_epoch=lo,
            n_epochs=hi - lo, n_bytes=(hi - lo) * bpe))

    stats = RunStats()
    pidx, pcnt = jax.process_index(), jax.process_count()
    t_start = time.time()
    for entry in manifest.shards:
        if entry.index % pcnt != pidx:
            continue
        path = os.path.join(out_dir, entry.path)
        if resume and os.path.exists(path) \
                and os.path.getsize(path) == entry.n_bytes:
            continue
        with open(path, "wb") as fp:
            s = run_epoch_range(scn, fp, entry.first_epoch,
                                entry.first_epoch + entry.n_epochs,
                                batch_epochs=batch_epochs, impl=impl,
                                log=log or (lambda s: None))
        stats.total_samples += s.total_samples
        stats.device_batches += s.device_batches
        stats.plan_seconds += s.plan_seconds
        stats.fetch_seconds += s.fetch_seconds
        stats.write_seconds += s.write_seconds
    stats.wall_seconds = time.time() - t_start

    if pidx == 0:
        manifest.save(manifest_path)
    return manifest, stats


def concat_shards(out_dir: str, out_file: str, check: bool = True):
    """Assemble shard files into the single-file gpssim.bin byte stream."""
    manifest = Manifest.load(os.path.join(out_dir, "manifest.json"))
    expect = 0
    with open(out_file, "wb") as out:
        for entry in sorted(manifest.shards, key=lambda s: s.first_epoch):
            if check and entry.first_epoch != expect:
                raise ValueError(
                    f"shard {entry.index} starts at epoch "
                    f"{entry.first_epoch}, expected {expect}")
            expect = entry.first_epoch + entry.n_epochs
            path = os.path.join(out_dir, entry.path)
            if check and os.path.getsize(path) != entry.n_bytes:
                raise ValueError(
                    f"shard {entry.index} is {os.path.getsize(path)} B, "
                    f"manifest says {entry.n_bytes} B")
            with open(path, "rb") as fp:
                while True:
                    chunk = fp.read(1 << 22)
                    if not chunk:
                        break
                    out.write(chunk)
    if check and expect != manifest.total_epochs:
        raise ValueError(f"shards cover {expect} epochs, "
                         f"manifest says {manifest.total_epochs}")
    return manifest
