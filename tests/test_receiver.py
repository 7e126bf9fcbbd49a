"""End-to-end loop closure: synthesize -> acquire -> track -> decode.

The software equivalent of the reference's hardware receiver validation
(SURVEY.md §4: u-center/ublox screenshots, rtk/ RTKLIB datasets): the
synthesized IQ stream must be acquirable, trackable, and its 50 bps nav
message must decode — parity-clean — to exactly the bits the scenario
encoder transmitted.
"""

import io

import numpy as np
import pytest

from gps_sdr_sim_tpu.constants import R2D
from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu.receiver import (acquire, bit_sync, decode_bits,
                                      frame_sync, load_iq, track)
from gps_sdr_sim_tpu.runner import run_simulation
from gps_sdr_sim_tpu.utils.coord import llh2xyz

pytestmark = [pytest.mark.receiver, pytest.mark.slow]

FS = 2.048e6
DURATION = 7.6  # covers one full subframe even after pull-in + prop delay

TOKYO = llh2xyz(np.array([35.681298 / R2D, 139.766247 / R2D, 10.0]))


@pytest.fixture(scope="module")
def scenario():
    cfg = ScenarioConfig(nav_file="data/brdc3540.14n", static_xyz=TOKYO,
                         duration=DURATION, samp_freq=FS, data_format=16)
    return build_scenario(cfg)


@pytest.fixture(scope="module")
def iq(scenario):
    buf = io.BytesIO()
    run_simulation(scenario, buf, batch_epochs=16, impl="xla",
                   log=lambda s: None)
    return load_iq(buf.getvalue(), 16)


@pytest.fixture(scope="module")
def acq(iq):
    return acquire(iq, FS, dopp_step=50.0, n_blocks=4)


def test_acquisition_finds_exactly_the_visible_sats(scenario, acq):
    seg = scenario.segments[0]
    visible = set(int(p) for p in seg.prn[seg.active])
    detected = set(a.prn for a in acq if a.detected)
    assert detected == visible


def test_acquired_doppler_matches_plan(scenario, acq):
    seg = scenario.segments[0]
    planned = {int(p): f for p, f in zip(seg.prn, seg.f_carr[0])
               if p > 0}
    for a in acq:
        if a.detected:
            # Fine stage: FFT over 16 ms -> a few Hz of resolution.
            assert abs(a.doppler - planned[a.prn]) < 15.0, a


@pytest.fixture(scope="module")
def tracked(iq, acq):
    return track(iq, FS, acq)


def test_tracking_converges_to_planned_doppler(scenario, tracked):
    seg = scenario.segments[0]
    last_epoch = seg.n_epochs - 1
    planned = {int(p): f for p, f in zip(seg.prn, seg.f_carr[last_epoch])
               if p > 0}
    for c, prn in enumerate(tracked.prns):
        assert abs(tracked.doppler[-1, c] - planned[int(prn)]) < 5.0, prn


def test_nav_message_decodes_bit_exact(scenario, tracked):
    seg = scenario.segments[0]
    bits_by_prn = {int(p): ((b + 1) // 2).astype(np.int8)
                   for p, b in zip(seg.prn, seg.bits) if p > 0}

    decoded_any = 0
    for c, prn in enumerate(tracked.prns):
        p = tracked.prompt[:, c]
        off = bit_sync(p)
        bits = decode_bits(p, off)
        sbfs = frame_sync(bits)
        assert sbfs, f"PRN {prn}: no parity-valid subframe decoded"
        tx = bits_by_prn[int(prn)]
        for sbf in sbfs:
            # The decoded 300 bits must appear verbatim in the transmitted
            # 1800-bit stream of this channel — in either polarity (the
            # Costas 180-degree ambiguity is invisible to parity/decode).
            tx_str = "".join(map(str, tx))
            got = "".join(map(str, sbf.bits))
            inv = "".join(map(str, 1 - sbf.bits))
            assert got in tx_str or inv in tx_str, \
                f"PRN {prn}: decoded bits not transmitted"
            assert sbf.tow_sec % 6.0 == 0.0
            if sbf.week is not None:
                assert sbf.week == 1823 % 1024  # start week from the oracle
            decoded_any += 1
    assert decoded_any >= len(tracked.prns)


def test_frontend_roundtrip_formats():
    import jax.numpy as jnp

    from gps_sdr_sim_tpu.ops.quantize import pack

    rng = np.random.default_rng(0)
    iq = rng.integers(-2000, 2000, size=(1, 64, 2)).astype(np.int16)

    x16 = load_iq(np.asarray(pack(jnp.asarray(iq), 16)).tobytes(), 16)
    assert np.array_equal(x16.real, iq[0, :, 0].astype(np.float32))
    assert np.array_equal(x16.imag, iq[0, :, 1].astype(np.float32))

    x8 = load_iq(np.asarray(pack(jnp.asarray(iq), 8)).tobytes(), 8)
    assert np.array_equal(x8.real, (iq[0, :, 0] >> 4).astype(np.float32))

    x1 = load_iq(np.asarray(pack(jnp.asarray(iq), 1)).tobytes(), 1)
    assert np.array_equal(x1.real, np.where(iq[0, :, 0] > 0, 1.0, -1.0))
    assert np.array_equal(x1.imag, np.where(iq[0, :, 1] > 0, 1.0, -1.0))


# ---------------------------------------------------------------------------
# Full PVT closure: 19.5 s capture -> decoded ephemeris -> position fix.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tracked26():
    # 26 s (iono ON) covers subframes 1-4: enough for ephemeris decode,
    # the Klobuchar parameters (subframe 4 page 18), and RINEX output.
    cfg = ScenarioConfig(nav_file="data/brdc3540.14n", static_xyz=TOKYO,
                         duration=26.0, samp_freq=FS, data_format=16)
    scn = build_scenario(cfg)
    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=16, impl="xla", log=lambda s: None)
    x = load_iq(buf.getvalue(), 16)
    acq = acquire(x, FS, dopp_step=50.0)
    return track(x, FS, acq)


@pytest.fixture(scope="module")
def pvt_solution(tracked26):
    from gps_sdr_sim_tpu.receiver.pvt import observables, solve

    obs, ionoutc = observables(tracked26)
    return obs, ionoutc, solve(obs, ionoutc)


def test_pvt_position_fix_matches_simulated_location(pvt_solution):
    obs, ionoutc, sol = pvt_solution
    assert ionoutc is not None and ionoutc.vflg
    err = np.linalg.norm(sol.xyz - TOKYO)
    assert sol.n_sats >= 4
    assert err < 10.0, f"position error {err:.2f} m with {sol.n_sats} sats"
    assert np.max(np.abs(sol.residuals)) < 5.0


def test_velocity_solution_is_zero_for_static_receiver(pvt_solution):
    """Doppler LS velocity (solve_velocity) on a static capture: the
    speed must be centimeters/s and the clock drift ~0 (the simulation
    has no receiver oscillator)."""
    from gps_sdr_sim_tpu.receiver.pvt import solve_velocity

    obs, _ionoutc, sol = pvt_solution
    vsol = solve_velocity(obs, sol)
    speed = np.linalg.norm(vsol.vel)
    assert vsol.n_sats >= 4
    assert speed < 0.05, f"static speed {speed:.3f} m/s"
    assert abs(vsol.clock_drift) < 1e-9
    assert np.max(np.abs(vsol.residuals)) < 0.05


def test_decoded_ephemeris_reencodes_identically(pvt_solution):
    """decode_ephemeris must be the exact inverse of eph2sbf."""
    from gps_sdr_sim_tpu.models.ephemeris import IonoUtc, read_rinex_nav_all
    from gps_sdr_sim_tpu.models.navmsg import eph2sbf

    obs, io_dec, _ = pvt_solution
    ionoutc = IonoUtc()
    eph_all, _neph = read_rinex_nav_all("data/brdc3540.14n", ionoutc)
    for o in obs:
        truth = eph_all[0][o.prn - 1]
        sbf_truth = eph2sbf(truth, ionoutc)
        sbf_dec = eph2sbf(o.eph, io_dec)
        # Subframes 1-3 carry the ephemeris, subframe 4 page 18 the
        # iono/UTC; wn/tow are injected later. All must re-encode exactly.
        np.testing.assert_array_equal(sbf_dec[:4], sbf_truth[:4])


def test_dynamic_trajectory_tracking():
    """Rover case (rtk/rover.csv analogue): track a moving receiver.

    The circle trajectory sweeps the carrier Doppler; the PLL must follow
    the planned per-epoch f_carr profile, not just the initial value.
    """
    cfg = ScenarioConfig(nav_file="data/brdc3540.14n",
                         motion_file="data/circle.csv",
                         duration=6.0, samp_freq=FS, data_format=16)
    scn = build_scenario(cfg)
    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=16, impl="xla", log=lambda s: None)
    x = load_iq(buf.getvalue(), 16)
    acq = acquire(x, FS, dopp_step=50.0)
    res = track(x, FS, acq)

    seg = scn.segments[0]
    cols = {int(p): i for i, p in enumerate(seg.prn) if p > 0}
    # The instantaneous loop readout jitters a few Hz; compare a 0.2 s
    # average against the planned per-epoch profile at 1 s and at the end.
    n_ms = res.doppler.shape[0]
    for c, prn in enumerate(res.prns):
        col = cols[int(prn)]
        for t_ms in (1000, n_ms - 100):
            planned = seg.f_carr[min(t_ms // 100, seg.n_epochs - 1), col]
            got = float(np.mean(res.doppler[t_ms:t_ms + 100, c]))
            assert abs(got - planned) < 5.0, (prn, t_ms, got, planned)


def test_acquisition_on_1bit_capture(scenario, iq, acq):
    """1-bit (sign-only) captures still acquire every visible satellite."""
    x1 = np.where(iq.real > 0, 1.0, -1.0) + 1j * np.where(iq.imag > 0,
                                                          1.0, -1.0)
    got = acquire(x1.astype(np.complex64), FS, dopp_step=50.0)
    want = {a.prn for a in acq if a.detected}
    assert {a.prn for a in got if a.detected} == want


def test_rover_pvt_fix_on_trajectory():
    """Instantaneous PVT of a MOVING receiver (rtk/rover analogue).

    The solver is single-epoch, so the fix must land on the trajectory at
    the measurement instant. Also regression-guards the bit-edge
    half-period ambiguity (pvt._bit_edge_chips): a wrong anchor on one
    channel is a 1 ms transmit-time error, ~300 km of pseudorange.
    """
    from gps_sdr_sim_tpu.models.trajectory import read_user_motion
    from gps_sdr_sim_tpu.receiver.pvt import observables, solve

    cfg = ScenarioConfig(nav_file="data/brdc3540.14n",
                         motion_file="data/circle.csv",
                         duration=26.0, samp_freq=FS, data_format=16)
    scn = build_scenario(cfg)
    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=16, impl="xla", log=lambda s: None)
    x = load_iq(buf.getvalue(), 16)
    res = track(x, FS, acquire(x, FS, dopp_step=50.0))
    m = res.prompt.shape[0] - 2
    obs, ionoutc = observables(res, m=m)
    sol = solve(obs, ionoutc)

    traj = read_user_motion("data/circle.csv")
    t = 0.1 + m / 1000.0  # capture starts at scenario epoch 1
    i0 = int(t * 10)
    frac = t * 10 - i0
    truth = traj[i0] * (1 - frac) + traj[min(i0 + 1, len(traj) - 1)] * frac
    err = np.linalg.norm(sol.xyz - truth)
    assert sol.n_sats >= 4
    assert err < 10.0, f"rover position error {err:.2f} m"
    assert np.max(np.abs(sol.residuals)) < 5.0

    # Velocity closure: the Doppler LS solution must land on the
    # trajectory's finite-difference velocity. The generator's Doppler is
    # itself a 0.1 s backward difference (gpssim.c:1324), so centered
    # truth at t - 0.05 s and a tolerance covering the circle's
    # centripetal acceleration over that skew (~0.7 m/s^2 * 0.05 s).
    from gps_sdr_sim_tpu.receiver.pvt import solve_velocity

    vsol = solve_velocity(obs, sol)
    tc = t - 0.05
    j0 = int(tc * 10)
    v_truth = (traj[min(j0 + 1, len(traj) - 1)] - traj[j0]) * 10.0
    verr = np.linalg.norm(vsol.vel - v_truth)
    assert verr < 0.25, f"rover velocity error {verr:.3f} m/s " \
                        f"(speed {np.linalg.norm(vsol.vel):.2f})"

    # Per-epoch single-point track (--pvt-track mode): each independent
    # solve lands on the trajectory at its own reception instant, with
    # the solution's own SOW stamp locating the truth point.
    from gps_sdr_sim_tpu.receiver.pvt import channel_frames

    frames = channel_frames(res)
    t0_sow = sol.t_gps - t  # capture-start SOW implied by the anchor fix
    for mk in (8000, 16000, 24000):
        obs_k, _ = observables(res, m=mk, frames=frames)
        s_k = solve(obs_k, ionoutc)
        tk = s_k.t_gps - t0_sow
        assert abs(tk - (0.1 + mk / 1000.0)) < 5e-3  # SOW stamp sanity
        i0 = int(tk * 10)
        frac = tk * 10 - i0
        tru = traj[i0] * (1 - frac) + traj[min(i0 + 1, len(traj) - 1)] * frac
        ek = np.linalg.norm(s_k.xyz - tru)
        assert ek < 10.0, f"track point at m={mk}: {ek:.2f} m"


def test_cn0_estimates_are_plausible(tracked):
    """NWPR C/N0 must be finite and ordered like the channel gains."""
    from gps_sdr_sim_tpu.receiver.navdec import cn0_estimate

    vals = [cn0_estimate(tracked.prompt[500:, c])
            for c in range(tracked.prompt.shape[1])]
    assert all(np.isfinite(v) for v in vals)
    assert all(20.0 < v < 60.0 for v in vals), vals


def test_pvt_on_85s_capture_across_ephemeris_set_advance():
    """Long-capture envelope (VERDICT r1 weak #6): an 85 s capture that
    crosses three 30 s nav refreshes AND the 2 h broadcast data-set
    cutover. Timeline (start 00:59:59): the set advance fires at the
    01:00:30 boundary (t=31 s, gpssim.c:2307-2326), but that boundary's
    nav message was generated from the PRE-advance sbf, so the new set's
    subframes first air in the frame from 01:01:00 (t=61 s) and complete
    by t~79 s.

    decode_sets must recover BOTH ephemeris sets (distinct IODEs),
    observables must anchor the late measurement on the post-cutover set,
    and the C/N0-weighted PVT must still fix within 10 m. Only the six
    strongest PRNs are tracked to bound CPU time.
    """
    from gps_sdr_sim_tpu.models.ephemeris import IonoUtc, read_rinex_nav_all
    from gps_sdr_sim_tpu.receiver.ephdec import decode_sets
    from gps_sdr_sim_tpu.receiver.pvt import channel_frames, observables, solve
    from gps_sdr_sim_tpu.utils.gpstime import DateTime

    cfg = ScenarioConfig(nav_file="data/brdc3540.14n", static_xyz=TOKYO,
                         duration=85.0, samp_freq=FS, data_format=16,
                         t0=DateTime(2014, 12, 20, 0, 59, 59.0))
    scn = build_scenario(cfg)
    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=16, impl="xla", log=lambda s: None)
    x = load_iq(buf.getvalue(), 16)
    acq = sorted([a for a in acquire(x, FS, dopp_step=50.0) if a.detected],
                 key=lambda a: -a.metric)[:6]
    res = track(x, FS, acq)
    frames = channel_frames(res)

    # Every tracked channel must see both data sets.
    n_dual = sum(1 for _off, _bits, sbfs in frames
                 if len(decode_sets(sbfs)) >= 2)
    assert n_dual >= 4, f"only {n_dual} channels decoded two ephemeris sets"

    # Late measurement: anchored on the post-cutover set.
    m = res.prompt.shape[0] - 2
    obs, ionoutc = observables(res, m=m)
    eph_all, _neph = read_rinex_nav_all("data/brdc3540.14n", IonoUtc())
    n_new = sum(1 for o in obs
                if abs(o.eph.toe.sec - eph_all[1][o.prn - 1].toe.sec) < 1e-9)
    assert n_new >= 4, f"only {n_new} channels anchored on the new set"

    sol = solve(obs, ionoutc, cn0_weighted=True)
    err = np.linalg.norm(sol.xyz - TOKYO)
    assert sol.n_sats >= 4
    assert err < 10.0, f"position error {err:.2f} m with {sol.n_sats} sats"
    assert np.max(np.abs(sol.residuals)) < 5.0


# ---- RINEX writers (the software RTKCONV of the reference's rtk/ flow) ----


def _parse_rinex_obs(text: str):
    """Minimal RINEX 2.11 obs parser for the tests."""
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln[60:].startswith("END OF HEADER")) + 1
    epochs = []
    while i < len(lines):
        hdr = lines[i]
        nsat = int(hdr[29:32])
        sats = [int(hdr[32 + 3 * j + 1:32 + 3 * j + 3])
                for j in range(min(nsat, 12))]
        i += 1
        for chunk in range(12, nsat, 12):
            cont = lines[i]
            sats += [int(cont[32 + 3 * j + 1:32 + 3 * j + 3])
                     for j in range(min(nsat - chunk, 12))]
            i += 1
        sec = (int(hdr[10:12]) * 3600 + int(hdr[13:15]) * 60
               + float(hdr[15:26]))
        obs = {}
        for prn in sats:
            ln = lines[i]
            obs[prn] = [float(ln[16 * j:16 * j + 14]) for j in range(4)]
            i += 1
        epochs.append((sec, obs))
    return epochs


@pytest.fixture(scope="module")
def rinex_files(tracked26):
    import io as _io

    from gps_sdr_sim_tpu.receiver.rinex import write_nav, write_obs

    fobs, fnav = _io.StringIO(), _io.StringIO()
    n_ep = write_obs(fobs, tracked26, interval=1.0)
    n_eph = write_nav(fnav, tracked26)
    assert n_ep >= 20 and n_eph >= 4
    return fobs.getvalue(), fnav.getvalue()


def test_rinex_obs_observables_are_self_consistent(scenario, rinex_files):
    """dL1/dt = -D1 (RTKCONV sign convention, verified against the
    reference's rtk/base.obs) and dC1/dt = -lambda*D1."""
    text, _ = rinex_files
    epochs = _parse_rinex_obs(text)
    assert len(epochs) >= 4
    lam = 299792458.0 / 1575.42e6
    seg = scenario.segments[0]
    visible = set(int(p) for p in seg.prn[seg.active])
    assert set(epochs[0][1].keys()) == visible
    for k in range(len(epochs) - 1):
        t0, o0 = epochs[k]
        t1, o1 = epochs[k + 1]
        dt = t1 - t0
        for prn in o0:
            c10, l10, d10, s10 = o0[prn]
            c11, l11, d11, _ = o1[prn]
            d_mid = 0.5 * (d10 + d11)
            assert abs((l11 - l10) / dt + d_mid) < 4.0, prn
            # code observables carry DLL jitter (~0.01 chip = 3 m per
            # epoch), so the differenced C1 rate is much noisier than L1
            assert abs((c11 - c10) / dt + lam * d_mid) < 15.0, prn
            assert 25.0 < s10 < 60.0, (prn, s10)  # low-elev ~32


def test_rinex_nav_roundtrips_through_our_parser(tmp_path, tracked26,
                                                 rinex_files):
    """The nav writer's records parse back field-exact (to the D19.12
    print precision) through models/ephemeris.py."""
    from gps_sdr_sim_tpu.models.ephemeris import IonoUtc, read_rinex_nav_all
    from gps_sdr_sim_tpu.receiver.ephdec import decode_sets
    from gps_sdr_sim_tpu.receiver.pvt import channel_frames

    _, nav_text = rinex_files
    p = tmp_path / "rx.nav"
    p.write_text(nav_text)
    eph, neph = read_rinex_nav_all(str(p), IonoUtc())
    assert neph >= 1

    frames = channel_frames(tracked26)
    n_checked = 0
    for c, prn in enumerate(tracked26.prns):
        _off, _bits, sbfs = frames[c]
        for es in decode_sets(sbfs):
            got = eph[0][int(prn) - 1]
            assert got.vflg == 1, prn
            for f in ("af0", "af1", "af2", "crs", "deltan", "m0", "cuc",
                      "ecc", "cus", "sqrta", "cic", "omg0", "cis", "inc0",
                      "crc", "aop", "omgdot", "idot", "tgd"):
                a, b = getattr(es.eph, f), getattr(got, f)
                assert np.isclose(a, b, rtol=1e-10, atol=1e-22), (prn, f)
            assert got.toe.sec == es.eph.toe.sec
            n_checked += 1
    assert n_checked >= 4


def test_rinex_pair_solves_position(tmp_path, rinex_files):
    """Full RTK-style closure from the two FILES alone: parse obs + nav
    with independent code paths and least-squares a position — the
    software analogue of feeding RTKCONV output to RTKLIB (rtk/)."""
    from gps_sdr_sim_tpu.models.ephemeris import IonoUtc, read_rinex_nav_all
    from gps_sdr_sim_tpu.receiver.pvt import ChannelObs, solve

    obs_text, nav_text = rinex_files
    p = tmp_path / "rx.nav"
    p.write_text(nav_text)
    eph, _ = read_rinex_nav_all(str(p), IonoUtc())
    epochs = _parse_rinex_obs(obs_text)
    C = 299792458.0
    # GPS day-of-week offset: the obs epoch seconds-of-day map onto the
    # 2014/12/20 seconds-of-week (Saturday = day 6).
    day_sec = 6 * 86400
    for sec, o in (epochs[0], epochs[-1]):
        chans = [ChannelObs(prn=prn, tx_time=day_sec + sec - c1 / C,
                            eph=eph[0][prn - 1])
                 for prn, (c1, _l1, _d1, _s1) in o.items()]
        sol = solve(chans)
        err = np.linalg.norm(sol.xyz - TOKYO)
        assert err < 60.0, f"position error {err:.1f} m at t={sec}"
