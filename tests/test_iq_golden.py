"""End-to-end IQ output vs committed C-reference golden files.

Golden streams were generated by the compiled reference simulator for 0.3 s
/ 1 Msps scenarios covering: static -l and -c modes, all three output
formats, dynamic -u (circle + rocket -i) and -g (NMEA) modes, -t start
time, and -T TOC/TOE overwrite.

Pass criterion (the reference's own float64 NCO accumulates ~1e-8
chips/cycles of rounding noise per epoch that a closed-form evaluation
cannot replicate exactly): mismatching samples <= 1e-4 of the stream with
|delta| <= 4 LSB, plus at most a couple of isolated chip-boundary flips.
"""

import io
import pathlib

import numpy as np
import pytest

from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu.runner import run_simulation
from gps_sdr_sim_tpu.utils.coord import llh2xyz
from gps_sdr_sim_tpu.utils.gpstime import DateTime
from gps_sdr_sim_tpu.constants import R2D

GOLDEN = pathlib.Path(__file__).parent / "golden"
DATA = pathlib.Path(__file__).parent.parent / "data"

TOKYO = llh2xyz(np.array([35.681298 / R2D, 139.766247 / R2D, 10.0]))

SCENARIOS = {
    "static16": dict(static_xyz=TOKYO, data_format=16),
    "static8": dict(static_xyz=TOKYO, data_format=8),
    "static1": dict(static_xyz=TOKYO, data_format=1),
    "ecef16": dict(static_xyz=np.array([3967283.154, 1022538.181,
                                        4872414.484]), data_format=16),
    "circle16": dict(motion_file=str(DATA / "circle.csv"), data_format=16),
    "gga16": dict(nmea_file=str(DATA / "triumphv3.txt"), data_format=16),
    "rocket16": dict(motion_file=str(DATA / "rocket.csv"), data_format=16,
                     iono_enable=False),
    "t016": dict(static_xyz=TOKYO, data_format=16,
                 t0=DateTime(2014, 12, 20, 1, 23, 45.0)),
    "tow16": dict(static_xyz=TOKYO, data_format=16,
                  t0=DateTime(2026, 8, 16, 0, 0, 0.0), timeoverwrite=True),
    # Golden from the reference compiled with FLOAT_CARR_PHASE undefined
    # (32-bit fixed-point carrier NCO, gpssim.c:2251-2252).
    "staticfix16": dict(static_xyz=TOKYO, data_format=16,
                        carrier_phase_mode="fixed"),
    # 8,000 km altitude: satellites pass within ~12,000 km, so the gain
    # model (path_loss = 20200000/d * ant * 128, gpssim.c:2178-2186)
    # reaches 202, well above the terrestrial ~128 — spacecraft-regime
    # oracle coverage.
    "highalt16": dict(static_xyz=llh2xyz(
        np.array([35.0 / R2D, 139.0 / R2D, 8.0e6])), data_format=16,
        iono_enable=False),
}


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDEN / "iq_golden.npz")


def synthesize(name, impl="xla"):
    kw = dict(SCENARIOS[name])
    cfg = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"), duration=0.3,
                         samp_freq=1.0e6, **kw)
    scn = build_scenario(cfg)
    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=4, log=lambda s: None, impl=impl)
    return np.frombuffer(buf.getvalue(), dtype=np.uint8)


def check(ours: np.ndarray, ref: np.ndarray, data_format: int):
    assert ours.size == ref.size, (ours.size, ref.size)
    if data_format == 1:
        a = np.unpackbits(ours)
        b = np.unpackbits(ref)
        frac = np.count_nonzero(a != b) / a.size
        assert frac <= 2e-5, f"bit mismatch fraction {frac}"
        return
    dtype = np.int16 if data_format == 16 else np.int8
    a = ours.view(dtype).astype(np.int32)
    b = ref.view(dtype).astype(np.int32)
    d = np.abs(a - b)
    small = np.count_nonzero(d)
    big = np.count_nonzero(d > 8)
    assert small / d.size <= 1e-4, f"mismatch fraction {small / d.size}"
    assert big <= 2, f"{big} chip-flip-scale mismatches"
    assert d[d <= 8].max(initial=0) <= 4


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_iq_vs_oracle_xla(goldens, name):
    ours = synthesize(name, impl="xla")
    check(ours, goldens[name], SCENARIOS[name].get("data_format", 16))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_iq_on_gpu_matches_cpu_and_oracle(gpu, goldens, name):
    """On the card: within the oracle bound, and byte-identical to the CPU
    run of the same kernel (the kernel is integer apart from exact f32
    floors, and its trig values are table lookups, so no backend may
    round differently)."""
    import jax

    ours = synthesize(name)
    check(ours, goldens[name], SCENARIOS[name].get("data_format", 16))
    with jax.default_device(jax.devices("cpu")[0]):
        on_cpu = synthesize(name)
    np.testing.assert_array_equal(ours, on_cpu)


# Rates whose epoch (samp_freq / 10 samples) is a different multiple of
# SUBBLOCK=2048: 1.0 Msps -> 48.8 sub-blocks, 1.31072 Msps -> exactly 64,
# 1.3312 Msps -> exactly 65, 2.5 Msps (USRP) -> 122.07, 2.6 Msps (the
# canonical rate) -> 126.95. Three epochs run in batches of two (the
# second padded with a silent epoch) and of one; the stream may not depend
# on how epochs are batched.
@pytest.mark.parametrize("samp_freq", [1.0e6, 1310720.0, 1331200.0, 2.5e6,
                                       2.6e6])
def test_runner_rates_batch_invariant(samp_freq):
    cfg = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                         static_xyz=TOKYO, duration=0.4, samp_freq=samp_freq)
    scn = build_scenario(cfg)
    assert scn.n_output_epochs == 3
    outs = []
    for batch_epochs in (2, 1):
        buf = io.BytesIO()
        run_simulation(scn, buf, batch_epochs=batch_epochs,
                       log=lambda s: None)
        outs.append(buf.getvalue())
    assert len(outs[0]) == scn.n_output_epochs * scn.iq_buff_size * 4
    assert outs[0] == outs[1]
    iq = np.frombuffer(outs[0], np.int16).reshape(scn.n_output_epochs, -1)
    assert np.all(np.count_nonzero(iq, axis=1) > 0)  # no silent epoch
