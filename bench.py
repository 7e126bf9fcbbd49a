"""Headline benchmark: the reference's own canonical workload.

Dynamic 300 s circle.csv at 2.6 Msps — exactly the `make time` scenario
the C reference is measured with (reference Makefile:32-35; BASELINE.md:
67.6 s wall = 4.4x real time on one CPU core, output to /dev/null) — in
all three output formats.

Metric: synthesis realtime factor on one GPU. Each pass runs the full
pipeline — host planning, device synthesis, quantization, and format
packing — with every batch materialized on the device and a per-batch
int32 checksum read back (proves the samples exist; XLA cannot DCE them).
The checksums must equal the committed golden values for this scenario
exactly, so the measured run is also a correctness check. Readback of the
samples themselves is not timed here; `python chip_smoke.py` times the
CLI's full stream.

Usage: python bench.py [--batch-epochs N] [--passes N]
       python bench.py --cpu --write-golden   (regenerates the goldens)
Prints ONE JSON line on stdout. Exits non-zero when JAX finds no GPU,
except with --cpu --write-golden.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pathlib
import subprocess
import sys
import time

_ROOT = pathlib.Path(__file__).parent
_GOLDEN = _ROOT / "tests" / "golden" / "bench_checksum.txt"
# C reference, 1 CPU core, output -> /dev/null (BASELINE.md / reference
# Makefile:32-35), per format.
_BASELINE_X = {16: 4.4, 8: 4.5, 1: 4.8}


def _golden_checksums() -> dict:
    """{bits: (sum, nonzero)} of the packed stream: the element sum wrapped
    to int32 and the nonzero-element count, over int16 samples (SC16),
    int8 samples (SC08) or packed bytes (SC01). One "<bits> <sum> <nonzero>"
    triple per line."""
    return {int(b): (int(s), int(z)) for b, s, z in
            (ln.split() for ln in _GOLDEN.read_text().splitlines()
             if ln.strip())}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-epochs", type=int, default=100)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--passes", type=int, default=3,
                    help="timed passes per format after one warmup pass")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; only with --write-golden")
    ap.add_argument("--write-golden", action="store_true",
                    help="write tests/golden/bench_checksum.txt from this "
                         "run's sums (use with --cpu)")
    ns = ap.parse_args()
    if ns.cpu and not ns.write_golden:
        ap.error("--cpu measures nothing; it is only for --write-golden")
    if ns.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    from gps_sdr_sim_tpu.utils.compcache import enable as enable_cache
    enable_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not ns.cpu:
        print(f"bench.py measures a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = None if ns.cpu else _card()

    from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
    from gps_sdr_sim_tpu.ops import synth_jnp
    from gps_sdr_sim_tpu.ops.plan import pad_epoch_axis, plan_batch
    from gps_sdr_sim_tpu.ops.quantize import pack
    from gps_sdr_sim_tpu.runner import iter_seg_batches

    cfg = ScenarioConfig(
        nav_file=str(_ROOT / "data" / "brdc3540.14n"),
        motion_file=str(_ROOT / "data" / "circle.csv"),
        duration=ns.duration, samp_freq=2.6e6, data_format=16)
    t0 = time.time()
    scn = build_scenario(cfg)
    print(f"scenario build: {time.time() - t0:.2f} s "
          f"({scn.n_output_epochs} epochs, {scn.total_samples:,} samples)",
          file=sys.stderr)
    n = scn.iq_buff_size
    B = ns.batch_epochs
    batches = list(iter_seg_batches(scn, 0, scn.n_output_epochs, B))

    # (sum, nonzero-element count) of a packed batch's valid region; both
    # reductions read one typed view, so XLA fuses them into one pass. A
    # batch of synthesized silence has nonzero == 0.
    @jax.jit
    def checksum(x):
        return (jnp.sum(x.astype(jnp.int32)),
                jnp.sum((x != 0).astype(jnp.int32)))

    def one_pass(fmt):
        t0 = time.time()
        sums, nzs = [], []
        for seg, e0, e1 in batches:
            db = pad_epoch_axis(plan_batch(seg, e0, e1, n, scn.delt), B)
            s, z = checksum(pack(synth_jnp.synth_batch(db, n), fmt)[:e1 - e0])
            sums.append(s)
            nzs.append(z)
        # One tiny readback closes the pipeline; int32 sums wrap, matching
        # the golden convention.
        csum = int(np.asarray(jnp.sum(jnp.stack(sums))))
        nz = np.asarray(jnp.stack(nzs)).astype(np.int64)
        return time.time() - t0, csum, int(nz.sum()), int(nz.min())

    goldens = {} if ns.write_golden else _golden_checksums()
    rt_of = scn.total_samples / scn.samp_freq  # rt factor = rt_of / wall
    passes = 0 if ns.write_golden else ns.passes
    results = {}
    for fmt in (16, 8, 1):
        walls = []
        for i in range(passes + 1):
            wall, csum, nz, nz_min = one_pass(fmt)
            if i > 0:
                walls.append(wall)
            print(f"sc{fmt:02d} {'warmup' if i == 0 else f'pass{i}'}: "
                  f"{wall:.3f} s wall, {rt_of / wall:.1f}x real time, "
                  f"checksum={csum}, nonzero={nz}", file=sys.stderr)
        verified = goldens.get(fmt) == (csum, nz) and nz_min > 0
        if goldens and not verified:
            print(f"sc{fmt:02d} CHECKSUM MISMATCH: got {csum}/{nz} "
                  f"(min batch nonzero {nz_min}), want "
                  f"{goldens.get(fmt)}", file=sys.stderr)
        results[fmt] = {"csum": csum, "nz": nz, "verified": verified,
                        "walls": walls}

    if ns.write_golden:
        _GOLDEN.write_text("".join(f"{fmt} {r['csum']} {r['nz']}\n"
                                   for fmt, r in results.items()))
        print(f"wrote {_GOLDEN}", file=sys.stderr)
        return 0

    rt = {fmt: rt_of / min(r["walls"]) for fmt, r in results.items()}
    print(json.dumps({
        "metric": "synthesis_realtime_factor_circle300s_2.6msps_sc16",
        "value": rt[16],
        "unit": "x_realtime",
        "vs_baseline": rt[16] / _BASELINE_X[16],
        "checksum_verified": all(r["verified"] for r in results.values()),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "started_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "batch_epochs": B,
        "formats": {f"sc{fmt:02d}": {
            "realtime_factor": rt[fmt],
            "vs_baseline": rt[fmt] / _BASELINE_X[fmt],
            "checksum_verified": r["verified"],
            "measure_walls_s": r["walls"],
        } for fmt, r in results.items()},
    }))
    return 0 if all(r["verified"] for r in results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
