"""Deep-run oracle verification: sampled-block comparison of an hours-long
static run against the C reference, without holding its output on disk.

The committed goldens cover 0.3 s and the live-oracle tests 35-65 s; this
script verifies multi-hour behavior — the 30 s nav refresh cadence and
REPEATED 2 h ephemeris-set advances (gpssim.c:2307-2332) — by streaming
the oracle's stdout (-o -) through a sampler that keeps only selected
epoch blocks, then synthesizing exactly those blocks with run_epoch_range
(any epoch range is independently computable; that is the framework's
checkpoint/resume design) and diffing per block.

Usage:
  python tools/deepcheck.py --duration 23400 --samp-freq 1e6 \
      --block-epochs 20 [--json out.json]

Runs on JAX's default device; JAX_PLATFORMS=cpu pins it to the host.

Block placement: one block at the start, one right after every expected
ephemeris-set advance, plus evenly spaced filler blocks — the regions where
a cadence bug would first corrupt the stream.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = pathlib.Path("/root/reference")
LOC = "35.681298,139.766247,10.0"


def build_oracle(tmp: pathlib.Path) -> pathlib.Path:
    for f in ("gpssim.c", "gpssim.h"):
        shutil.copy(REF / f, tmp / f)
    subprocess.run(["gcc", "gpssim.c", "-lm", "-O3", "-o", "gps-sdr-sim"],
                   cwd=tmp, check=True, capture_output=True)
    return tmp / "gps-sdr-sim"


def pick_blocks(scn, block_epochs: int, n_filler: int):
    """Epoch ranges to sample: after each ephemeris-set advance + filler."""
    total = scn.n_output_epochs
    starts = {0}
    # Segments begin right after each 30 s boundary; set advances happen at
    # boundaries where grx crosses (toc - 1 h) of the next set — sample the
    # first block of every hour-and-a-bit to be sure each advance region is
    # covered, plus evenly spaced filler.
    for h in range(1, int(scn.numd * 0.1 // 3600) + 1):
        starts.add(min(h * 36000, total - block_epochs))
    for k in range(1, n_filler + 1):
        starts.add(k * (total - block_epochs) // (n_filler + 1))
    return sorted((s, min(s + block_epochs, total)) for s in starts
                  if s < total)


def stream_sample(cmd, ranges_bytes, total_bytes):
    """Run `cmd`, keep only [lo, hi) byte ranges of its stdout."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, bufsize=1 << 20)
    keep = {lo: bytearray() for lo, _hi in ranges_bytes}
    ranges = sorted(ranges_bytes)
    pos = 0
    ri = 0
    CHUNK = 1 << 22
    while True:
        chunk = proc.stdout.read(CHUNK)
        if not chunk:
            break
        end = pos + len(chunk)
        while ri < len(ranges) and ranges[ri][1] <= pos:
            ri += 1
        for lo, hi in ranges[ri:]:
            if lo >= end:
                break
            a, b = max(lo, pos), min(hi, end)
            if a < b:
                keep[lo] += chunk[a - pos:b - pos]
        pos = end
    proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"oracle exited {proc.returncode}")
    if pos != total_bytes:
        raise RuntimeError(f"oracle wrote {pos} bytes, expected {total_bytes}")
    return keep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=23400.0,
                    help="seconds; 23400 = 6.5 h, crossing 3 set advances")
    ap.add_argument("--samp-freq", type=float, default=1.0e6)
    ap.add_argument("--block-epochs", type=int, default=20)
    ap.add_argument("--filler-blocks", type=int, default=6)
    ap.add_argument("--json", default="")
    ns = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from gps_sdr_sim_tpu.constants import R2D
    from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
    from gps_sdr_sim_tpu.runner import run_epoch_range
    from gps_sdr_sim_tpu.utils.compcache import enable as enable_cache
    from gps_sdr_sim_tpu.utils.coord import llh2xyz

    enable_cache()
    lat, lon, hgt = (float(v) for v in LOC.split(","))
    cfg = ScenarioConfig(
        nav_file=str(ROOT / "data" / "brdc3540.14n"),
        samp_freq=ns.samp_freq, duration=ns.duration,
        static_xyz=llh2xyz(np.array([lat / R2D, lon / R2D, hgt])))

    t0 = time.time()
    scn = build_scenario(cfg)
    print(f"scenario: {scn.n_output_epochs} epochs, "
          f"{len(scn.segments)} segments, build {time.time() - t0:.1f} s",
          file=sys.stderr)

    blocks = pick_blocks(scn, ns.block_epochs, ns.filler_blocks)
    bpe = scn.iq_buff_size * 4  # SC16 bytes per epoch
    total_bytes = scn.n_output_epochs * bpe
    ranges_bytes = [(lo * bpe, hi * bpe) for lo, hi in blocks]
    print(f"sampling {len(blocks)} blocks of {ns.block_epochs} epochs "
          f"from {total_bytes / 1e9:.1f} GB of oracle output",
          file=sys.stderr)

    with tempfile.TemporaryDirectory() as td:
        oracle = build_oracle(pathlib.Path(td))
        t0 = time.time()
        kept = stream_sample(
            [str(oracle), "-e", str(ROOT / "data" / "brdc3540.14n"),
             "-l", LOC, "-d", str(ns.duration),
             "-s", str(int(ns.samp_freq)), "-o", "-"],
            ranges_bytes, total_bytes)
        print(f"oracle run: {time.time() - t0:.1f} s", file=sys.stderr)

    import io

    report = []
    worst = {"frac": 0.0, "max": 0, "big": 0}
    for (lo, hi), (blo, _bhi) in zip(blocks, ranges_bytes):
        buf = io.BytesIO()
        run_epoch_range(scn, buf, lo, hi, batch_epochs=ns.block_epochs,
                        log=lambda s: None)
        a = np.frombuffer(buf.getvalue(), np.int16).astype(np.int32)
        b = np.frombuffer(bytes(kept[blo]), np.int16).astype(np.int32)
        assert a.size == b.size, (lo, hi, a.size, b.size)
        d = np.abs(a - b)
        frac = float(np.count_nonzero(d) / d.size)
        entry = {
            "epochs": [lo, hi], "t_start_s": round(lo * 0.1, 1),
            "samples": int(d.size), "mismatch_fraction": round(frac, 8),
            "max_delta": int(d.max(initial=0)),
            "big": int(np.count_nonzero(d > 8)),
        }
        report.append(entry)
        worst["frac"] = max(worst["frac"], frac)
        worst["max"] = max(worst["max"], entry["max_delta"])
        worst["big"] += entry["big"]
        print(json.dumps(entry), file=sys.stderr)

    ok = worst["frac"] <= 1e-4 and worst["max"] <= 8 and worst["big"] == 0
    summary = {
        "metric": "deep_oracle_sampled_blocks",
        "duration_s": ns.duration, "samp_freq": ns.samp_freq,
        "blocks": len(blocks), "worst_mismatch_fraction": worst["frac"],
        "worst_max_delta": worst["max"], "big_mismatches": worst["big"],
        "pass": ok, "detail": report,
    }
    if ns.json:
        pathlib.Path(ns.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "detail"}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
