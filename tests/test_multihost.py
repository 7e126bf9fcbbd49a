"""Real multi-process run: two jax.distributed processes share the work.

Spawns two CLI processes joined through a jax.distributed coordinator on
localhost; each writes its own disjoint time-shards (parallel/writer.py
interleaves shard indices by process), and the concatenated result must be
byte-identical to a single-process run. This is the DCN path of SURVEY.md
§2.4 exercised for real, not just unit-mocked.
"""

import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = [pytest.mark.slow]

ROOT = pathlib.Path(__file__).parent.parent
ARGS = ["-e", "data/brdc3540.14n", "-l", "35.681298,139.766247,10.0",
        "-d", "0.8", "-s", "1000000", "--impl", "xla",
        "--batch-epochs", "2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_run_matches_single(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": "/root",
           "JAX_PLATFORMS": "cpu",
           "GPS_SDR_SIM_NO_CACHE": "1",
           "PYTHONPATH": str(ROOT)}

    single = tmp_path / "single.bin"
    subprocess.run(
        [sys.executable, "-m", "gps_sdr_sim_tpu.cli", *ARGS,
         "-o", str(single)],
        cwd=ROOT, env=env, check=True, capture_output=True, timeout=300)

    port = _free_port()
    shard_dir = tmp_path / "shards"
    multi = tmp_path / "multi.bin"
    # --concat goes through the cross-process barrier and is performed by
    # process 0 only, after every host's shards are complete.
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "gps_sdr_sim_tpu.cli", *ARGS,
             "-o", str(multi), "--shard-dir", str(shard_dir),
             "--shards", "4", "--concat",
             "--multihost", f"127.0.0.1:{port},{pid},2"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        for pid in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()

    from gps_sdr_sim_tpu.parallel.writer import Manifest

    manifest = Manifest.load(str(shard_dir / "manifest.json"))
    assert len(manifest.shards) == 4

    a = np.fromfile(single, np.int16)
    b = np.fromfile(multi, np.int16)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)
