"""CLI contract tests: flag parity with the reference getopt surface
(gpssim.c:1650-1852) plus the sharding extensions.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from gps_sdr_sim_tpu.cli import main

DATA = pathlib.Path(__file__).parent.parent / "data"
NAV = str(DATA / "brdc3540.14n")
ARGS = ["-e", NAV, "-l", "30.286502,120.032669,100", "-s", "1000000",
        "-d", "0.3", "--impl", "xla", "--batch-epochs", "2"]


def test_missing_ephemeris_flag(capsys):
    with pytest.raises(SystemExit):
        main(["-l", "30.0,120.0,100"])
    assert "not specified" in capsys.readouterr().err


def test_invalid_format(capsys):
    with pytest.raises(SystemExit):
        main(["-e", NAV, "-b", "12"])
    assert "Invalid I/Q data format" in capsys.readouterr().err


def test_invalid_sampling_frequency(capsys):
    with pytest.raises(SystemExit):
        main(["-e", NAV, "-s", "999999"])
    assert "Invalid sampling frequency" in capsys.readouterr().err


def test_invalid_start_time(capsys):
    rc = main(["-e", NAV, "-t", "2020/01/01,00:00:00", "-d", "0.1"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "Invalid start time" in err and "tmin" in err


def test_end_to_end_static(tmp_path, capsys):
    out = tmp_path / "out.bin"
    rc = main(ARGS + ["-o", str(out)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "Using static location mode." in err
    assert "Start time = 2014/12/20,00:00:00 (1823:518400)" in err
    assert out.stat().st_size == 2 * 100000 * 4  # 2 epochs SC16 @ 1 Msps


def test_sharded_output_matches_single(tmp_path):
    single = tmp_path / "single.bin"
    assert main(ARGS + ["-o", str(single)]) == 0

    shard_dir = tmp_path / "shards"
    joined = tmp_path / "joined.bin"
    rc = main(ARGS + ["-o", str(joined), "--shard-dir", str(shard_dir),
                      "--shards", "2", "--concat"])
    assert rc == 0
    assert (shard_dir / "manifest.json").exists()
    assert joined.read_bytes() == single.read_bytes()


def test_satellite_trajectory_motion_size(tmp_path, capsys):
    """satellite.csv has 3,001 rows: needs the runtime --motion-size knob
    (the reference requires recompiling with USER_MOTION_SIZE, gpssim.h:19)."""
    out = tmp_path / "sat.bin"
    rc = main(["-e", NAV, "-u", "data/satellite.csv", "-i", "-d", "0.4",
               "-s", "1000000", "--impl", "xla", "--batch-epochs", "2",
               "--motion-size", "4000", "-o", str(out)])
    assert rc == 0
    # numd-1 output epochs, like the reference (300 s circle -> 2999).
    assert out.stat().st_size == 3 * 100000 * 4


def test_negative_coordinates_accepted(tmp_path):
    """getopt compatibility: -c/-l operands may start with a minus sign."""
    out = tmp_path / "west.bin"
    rc = main(["-e", NAV, "-c", "-2694685.473,-4293642.366,3857878.924",
               "-d", "0.3", "-s", "1000000", "--impl", "xla",
               "--batch-epochs", "2", "-o", str(out)])
    assert rc == 0 and out.stat().st_size > 0


def test_static_location_wins_over_motion_file(tmp_path, capsys):
    """Reference precedence: staticLocationMode gates the motion read
    entirely (gpssim.c:1887), so -l + -u behaves as static."""
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    base = ["-e", NAV, "-d", "0.3", "-s", "1000000", "--impl", "xla",
            "--batch-epochs", "2"]
    assert main([*base, "-l", "35.681298,139.766247,10.0",
                 "-u", "data/circle.csv", "-o", str(a)]) == 0
    assert "static location" in capsys.readouterr().err
    assert main([*base, "-l", "35.681298,139.766247,10.0",
                 "-o", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_missing_motion_file_error(capsys):
    rc = main(["-e", NAV, "-u", "no_such_file.csv", "-d", "0.3"])
    assert rc == 1
    assert "Failed to open user motion / NMEA GGA file." \
        in capsys.readouterr().err


def test_stdout_pipes_into_native_player(tmp_path):
    """The L5->L6 handoff as a live pipe: CLI -o - | gps-sdr-player -f -."""
    import pathlib
    import subprocess
    import sys as _sys

    player = pathlib.Path("tools/gps-sdr-player")
    if not player.exists():
        subprocess.run(["make", "-C", "tools"], check=True,
                       capture_output=True)
    out = tmp_path / "piped.bin"
    gen = subprocess.Popen(
        [_sys.executable, "-m", "gps_sdr_sim_tpu.cli", "-e", NAV,
         "-l", "35.681298,139.766247,10.0", "-d", "0.3", "-s", "1000000",
         "--impl", "xla", "--batch-epochs", "2", "-o", "-"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    play = subprocess.run(
        [str(player), "-f", "-", "-b", "16", "-B", "file", "-o", str(out)],
        stdin=gen.stdout, capture_output=True, timeout=300)
    assert gen.wait(timeout=300) == 0
    assert play.returncode == 0, play.stderr.decode()
    # 2 epochs of SC16 passed through the player unmodified (+ trailing pad).
    direct = tmp_path / "direct.bin"
    assert main(["-e", NAV, "-l", "35.681298,139.766247,10.0", "-d", "0.3",
                 "-s", "1000000", "--impl", "xla", "--batch-epochs", "2",
                 "-o", str(direct)]) == 0
    want = direct.read_bytes()
    assert out.read_bytes()[:len(want)] == want


def test_zero_duration_dynamic_writes_nothing(tmp_path, capsys):
    """-d 0 prints the channel table and writes no samples (no traceback)."""
    out = tmp_path / "zero.bin"
    rc = main(["-e", NAV, "-u", "data/circle.csv", "-d", "0", "-s",
               "1000000", "--impl", "xla", "-o", str(out)])
    assert rc == 0
    assert out.stat().st_size == 0
    err = capsys.readouterr().err
    assert "Duration = 0.0" in err


@pytest.mark.parametrize("impl", ["pallas", "pallas-sharded"])
def test_impl_rejects_removed_values(capsys, impl):
    with pytest.raises(SystemExit):
        main(["-e", NAV, "-d", "0.1", "--impl", impl])
    assert "invalid choice" in capsys.readouterr().err


def test_json_summary_names_the_device(tmp_path):
    import json

    summary = tmp_path / "run.json"
    assert main(ARGS + ["-o", str(tmp_path / "out.bin"),
                        "--json-summary", str(summary)]) == 0
    d = json.loads(summary.read_text())
    assert d["platform"] == "cpu"
    assert d["device_count"] == 8  # the virtual CPU mesh of conftest.py
    assert isinstance(d["device_kind"], str) and d["device_kind"]
    assert d["total_samples"] == 2 * 100000


_CACHE_PROBE = """
import json, os, jax, jax.numpy as jnp
from gps_sdr_sim_tpu.utils import compcache
compcache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: jnp.cumsum(x * 3) + 1)(jnp.arange(7.0)).block_until_ready()
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir,
                  "default": compcache.DEFAULT_DIR}))
"""


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and the code sets
    no other; unset, the cache is the checkout's fixed .jax_cache/."""
    import json
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(pathlib.Path(__file__).parent.parent))
    env.pop("GPS_SDR_SIM_NO_CACHE", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    cache = tmp_path / "cache"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    d = json.loads(r.stdout.strip().splitlines()[-1])
    root = pathlib.Path(__file__).resolve().parent.parent
    assert d["default"] == str(root / ".jax_cache")
    if env_dir:
        assert d["dir"] == str(cache)
        assert any(cache.iterdir())  # the compiled entry landed there
    else:
        assert d["dir"] == d["default"]
