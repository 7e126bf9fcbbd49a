"""chip_smoke.py's own logic, on the CPU: its stream checksum against the
convention of tests/golden/bench_checksum.txt, and its device check."""

import io
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from gps_sdr_sim_tpu.constants import R2D
from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu.runner import run_simulation
from gps_sdr_sim_tpu.utils.coord import llh2xyz

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _feed(ck, data: bytes):
    """Feed `data` in chunks of awkward sizes (elements split across)."""
    i, k = 0, 0
    sizes = (1, 7, 4097, 3, 65536)
    while i < len(data):
        ck.update(data[i:i + sizes[k % len(sizes)]])
        i += sizes[k % len(sizes)]
        k += 1
    return ck.result()


@pytest.mark.parametrize("fmt", [16, 8, 1])
def test_stream_checksum_matches_bench_convention(fmt):
    """On a CPU stream: chip_smoke's chunked checksum equals the int32
    device-side checksum that wrote the golden file (bench.py)."""
    cfg = ScenarioConfig(
        nav_file=str(ROOT / "data" / "brdc3540.14n"), duration=0.4,
        samp_freq=1.0e6, data_format=fmt,
        static_xyz=llh2xyz(np.array([35.681298 / R2D, 139.766247 / R2D,
                                     10.0])))
    buf = io.BytesIO()
    run_simulation(build_scenario(cfg), buf, batch_epochs=2,
                   log=lambda s: None)
    data = buf.getvalue()
    v = jnp.asarray(np.frombuffer(data, chip_smoke.ELEM[fmt]))
    want = (len(data), int(jnp.sum(v.astype(jnp.int32))),
            int(jnp.sum((v != 0).astype(jnp.int32))))
    assert want[2] > 0
    assert _feed(chip_smoke.StreamChecksum(fmt), data) == want


def test_stream_checksum_wraps_like_int32():
    """A sum past 2^31 wraps exactly as the golden's int32 sums do."""
    v = np.full(100_001, 32767, np.int16)
    v[::3] = -7
    want = int(jnp.sum(jnp.asarray(v).astype(jnp.int32)))
    assert v.astype(np.int64).sum() > 2**31 and want < 0
    assert _feed(chip_smoke.StreamChecksum(16), v.tobytes()) == (
        v.nbytes, want, v.size)


def test_stream_checksum_refuses_a_split_element():
    ck = chip_smoke.StreamChecksum(16)
    ck.update(b"\x01\x02\x03")
    with pytest.raises(chip_smoke.SmokeFailure):
        ck.result()


def test_device_check_refuses_the_cpu():
    info = chip_smoke.device_info("cpu")  # a child with JAX_PLATFORMS=cpu
    assert info["platform"] == "cpu"
    with pytest.raises(chip_smoke.SmokeFailure, match="not a GPU"):
        chip_smoke.check_device(info)
    with pytest.raises(chip_smoke.SmokeFailure, match="need 4 GPUs"):
        chip_smoke.check_device(dict(info, platform="gpu", count=1), 4)


def test_detected_prns_reads_the_receiver_table():
    out = ("PRN  doppler[Hz]  code_phase[samp]  metric\n"
           " 11     +1234.5           101.0     40.2\n"
           "  3      -250.0          2047.0     18.9\n")
    assert chip_smoke.detected_prns(out) == {3, 11}
