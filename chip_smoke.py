"""Smoke test of the synthesizer on one NVIDIA GPU: the quickest proof that
the system still starts on the card and writes the right bytes.

    python chip_smoke.py           # one GPU, the phases below
    python chip_smoke.py --four    # four GPUs: the sharded path only

This process stays off JAX. Each phase is one child process, run one after
another with JAX_PLATFORMS=cuda (JAX then fails instead of falling back to
the CPU), so one process at a time holds the card. Phases:

1. device:   the platform, device kind and count as JAX reports them, and
             the card's name and power limit from nvidia-smi;
2. tests:    `python -m pytest -m gpu tests/` (the tests that need a card);
3. full:     the reference's `make time` workload through the CLI — 300 s
             of circle.csv at 2.6 Msps, once per format (-b 16/8/1), on a
             stdout pipe. Byte count, int32-wrapped element sum and
             nonzero-element count must equal tests/golden/bench_checksum.txt
             exactly (the CPU result);
4. receiver: a 2 s static capture made on the card, acquired by
             `python -m gps_sdr_sim_tpu.receiver` on the card and on the
             CPU; both must detect the same PRNs, at least 8 of them.

With --four: runner impl "xla-sharded" over 4 cards on 30 s of circle.csv
at 2.6 Msps SC16, byte-identical to the one-card run (two runs of each,
in turns), and
__graft_entry__.dryrun_multichip(4) (a 2x2 mesh with the pre-quantization
psum).

Any failed phase exits non-zero. The last line printed is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "bench_checksum.txt"
NAV = "data/brdc3540.14n"
FULL_ARGS = ["-e", NAV, "-u", "data/circle.csv", "-d", "300",
             "-s", "2600000"]
FULL_SECONDS = 300.0
# Every child is killed at this deadline, so the whole script ends within
# the 1200 s a smoke run may take.
DEADLINE = time.time() + 1150.0
# Element type of the checksum view per format: int16 samples (SC16),
# int8 samples (SC08), packed bytes (SC01).
ELEM = {16: np.int16, 8: np.int8, 1: np.uint8}


class SmokeFailure(Exception):
    pass


def _env(platforms: str) -> dict:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, JAX_PLATFORMS=platforms,
                PYTHONPATH=str(ROOT) + (os.pathsep + path if path else ""))


def _left(timeout: float) -> float:
    return max(1.0, min(timeout, DEADLINE - time.time()))


def _run(cmd, platforms: str, timeout: float) -> str:
    """Run one child to its end; its stdout, or SmokeFailure."""
    r = subprocess.run(cmd, env=_env(platforms), cwd=ROOT,
                       timeout=_left(timeout), capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise SmokeFailure(f"{' '.join(map(str, cmd))} exited "
                           f"{r.returncode}:\n{r.stdout[-3000:]}\n"
                           f"{r.stderr[-3000:]}")
    return r.stdout


_DEVICE_PROBE = ("import jax, json; d = jax.devices(); print(json.dumps("
                 "{'platform': d[0].platform, 'kind': d[0].device_kind, "
                 "'count': len(d)}))")


def device_info(platforms: str = "cuda") -> dict:
    """The default device as a child process with these platforms sees it."""
    out = _run([sys.executable, "-c", _DEVICE_PROBE], platforms, 300)
    return json.loads(out.strip().splitlines()[-1])


def check_device(info: dict, count: int = 1) -> None:
    if info["platform"] != "gpu":
        raise SmokeFailure(f"JAX found {info['platform']}, not a GPU")
    if info["count"] < count:
        raise SmokeFailure(f"need {count} GPUs, JAX found {info['count']}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


class StreamChecksum:
    """Byte count, element sum mod 2^32 (as signed int32) and nonzero
    element count of a byte stream fed in chunks of any size — the
    convention of tests/golden/bench_checksum.txt."""

    def __init__(self, fmt: int):
        self.dtype = np.dtype(ELEM[fmt])
        self.n_bytes = 0
        self.total = 0
        self.nonzero = 0
        self._tail = b""

    def update(self, chunk: bytes) -> None:
        self.n_bytes += len(chunk)
        data = self._tail + chunk
        cut = len(data) - len(data) % self.dtype.itemsize
        self._tail = data[cut:]
        v = np.frombuffer(data[:cut], self.dtype)
        self.total += int(v.sum(dtype=np.int64))
        self.nonzero += int(np.count_nonzero(v))

    def result(self) -> tuple[int, int, int]:
        if self._tail:
            raise SmokeFailure(f"stream ends inside an element "
                               f"({len(self._tail)} stray bytes)")
        wrapped = (self.total + 2**31) % 2**32 - 2**31
        return self.n_bytes, wrapped, self.nonzero


def golden_checksums() -> dict:
    """{bits: (bytes, sum, nonzero)} for the 300 s make-time stream: 2999
    epochs of 260,000 samples (BASELINE.md)."""
    n_bytes = {16: 3_118_960_000, 8: 1_559_480_000, 1: 194_935_000}
    out = {}
    for ln in GOLDEN.read_text().splitlines():
        if ln.strip():
            b, s, z = (int(t) for t in ln.split())
            out[b] = (n_bytes[b], s, z)
    return out


def full_scale(fmt: int, card: str, tmp: pathlib.Path) -> None:
    """The CLI's 300 s make-time run on the card, read from its stdout."""
    summary = tmp / f"sc{fmt:02d}.json"
    log = tmp / f"sc{fmt:02d}.log"
    cmd = [sys.executable, "-m", "gps_sdr_sim_tpu.cli", *FULL_ARGS,
           "-b", str(fmt), "-o", "-", "--json-summary", str(summary)]
    ck = StreamChecksum(fmt)
    t0 = time.time()
    t_first = None
    with open(log, "wb") as err:
        proc = subprocess.Popen(cmd, env=_env("cuda"), cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=err)
        watchdog = threading.Timer(_left(400), proc.kill)
        watchdog.start()
        try:
            while chunk := proc.stdout.read(1 << 23):
                if t_first is None:
                    t_first = time.time() - t0
                ck.update(chunk)
            rc = proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.time() - t0
    if rc != 0:
        raise SmokeFailure(f"sc{fmt:02d} CLI exited {rc}:\n"
                           + log.read_text(errors="replace")[-3000:])
    got = ck.result()
    want = golden_checksums()[fmt]
    run = json.loads(summary.read_text())
    print(f"full sc{fmt:02d}: bytes={got[0]} sum={got[1]} nonzero={got[2]} "
          f"time_to_first_byte_s={t_first} wall_s={wall} "
          f"realtime_factor={FULL_SECONDS / wall} "
          f"runner_realtime_factor={run['realtime_factor']} "
          f"platform={run['platform']} [{card}]", flush=True)
    if got != want:
        raise SmokeFailure(f"sc{fmt:02d} stream {got} != golden {want}")
    if run["platform"] != "gpu":
        raise SmokeFailure(f"sc{fmt:02d} ran on {run['platform']}")


def detected_prns(receiver_stdout: str) -> set:
    """PRNs of the receiver's acquisition table (one row per detection)."""
    prns = set()
    for ln in receiver_stdout.splitlines():
        tok = ln.split()
        if len(tok) == 4 and tok[0].isdigit():
            prns.add(int(tok[0]))
    return prns


def receiver(card: str, tmp: pathlib.Path) -> None:
    cap = tmp / "static2s.bin"
    _run([sys.executable, "-m", "gps_sdr_sim_tpu.cli", "-e", NAV,
          "-l", "35.681298,139.766247,10.0", "-d", "2", "-s", "2600000",
          "-b", "16", "-o", str(cap)], "cuda", 300)
    rx = [sys.executable, "-m", "gps_sdr_sim_tpu.receiver", str(cap),
          "-s", "2600000", "-b", "16"]
    t0 = time.time()
    on_gpu = detected_prns(_run(rx, "cuda", 300))
    t_gpu = time.time() - t0
    on_cpu = detected_prns(_run(rx, "cpu", 300))
    print(f"receiver: gpu PRNs {sorted(on_gpu)}, cpu PRNs {sorted(on_cpu)}, "
          f"gpu child wall_s={t_gpu} [{card}]", flush=True)
    if on_gpu != on_cpu or len(on_gpu) < 8:
        raise SmokeFailure("receiver PRN sets differ or are too small")


_FOUR = """
import hashlib, io, json, sys, time
import jax
from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu.runner import run_simulation
import __graft_entry__ as graft

class Digest:
    def __init__(self):
        self.h, self.n = hashlib.sha256(), 0
    def write(self, b):
        self.h.update(b)
        self.n += len(memoryview(b).cast("B"))

assert len(jax.devices()) == 4 and jax.devices()[0].platform == "gpu"
scn = build_scenario(ScenarioConfig(
    nav_file="data/brdc3540.14n", motion_file="data/circle.csv",
    duration=30.0, samp_freq=2.6e6, data_format=16))
runs = []
for impl in ("xla", "xla-sharded", "xla", "xla-sharded"):
    d = Digest()
    t0 = time.time()
    run_simulation(scn, d, impl=impl, log=lambda s: None)
    runs.append([impl, d.h.hexdigest(), d.n, time.time() - t0])
graft.dryrun_multichip(4)
print(json.dumps(runs))
"""


def four(card: str) -> None:
    t0 = time.time()
    runs = json.loads(_run([sys.executable, "-c", _FOUR], "cuda",
                           900).strip().splitlines()[-1])
    for impl, digest, n_bytes, wall in runs:  # the first of each compiles
        print(f"four: {impl} {n_bytes} bytes sha256={digest[:16]} "
              f"wall_s={wall} [{card}]", flush=True)
    same = len({(digest, n) for _i, digest, n, _w in runs}) == 1
    print(f"four: xla-sharded over 4 cards == one card: {same}; "
          f"dryrun_multichip(4) ok; wall_s={time.time() - t0} [{card}]",
          flush=True)
    if not same:
        raise SmokeFailure("xla-sharded output differs from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    ns = ap.parse_args(argv)
    if not (ROOT / "gps_sdr_sim_tpu").is_dir() or not GOLDEN.exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    try:
        info = device_info()
        count = 4 if ns.four else 1
        check_device(info, count)
        card = card_line()
        print(f"card: {card}", flush=True)
        print(f"device: platform={info['platform']} kind={info['kind']} "
              f"count={info['count']} [{card}]", flush=True)
        if ns.four:
            four(card)
        else:
            t0 = time.time()
            out = _run([sys.executable, "-m", "pytest", "-m", "gpu",
                        "tests/", "-q", "-p", "no:cacheprovider"],
                       "cuda,cpu", 600)
            tail = out.strip().splitlines()[-1]
            if "passed" not in tail or "skipped" in tail:
                raise SmokeFailure(f"gpu tests did not all run: {tail}")
            print(f"tests: {tail} wall_s={time.time() - t0} [{card}]",
                  flush=True)
            with tempfile.TemporaryDirectory() as d:
                for fmt in (16, 8, 1):
                    full_scale(fmt, card, pathlib.Path(d))
                receiver(card, pathlib.Path(d))
    except (SmokeFailure, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
