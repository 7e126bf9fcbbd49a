"""RINEX 2.11 writers for the software receiver's observables.

The reference validates its signal by capturing it on a u-blox receiver,
converting with RTKCONV to RINEX obs/nav (rtk/base.obs: C1 L1 D1 S1 at
1 Hz + rtk/base.nav), and post-processing with RTKLIB (SURVEY.md §2.3).
This module produces the same artifact pair from the software tracking
channels, so the whole RTK-style validation chain runs hardware-free:

 - C1: pseudorange from the reconstructed SV transmit time (the PVT
   observable, receiver/pvt.py) against a nominal receiver clock steered
   onto whole GPS seconds (like a hardware receiver's measurement grid);
 - L1: integrated carrier phase (cycles) from the per-block PLL Doppler,
   with RTKCONV's sign convention (dL1/dt = -D1, phase moves with range;
   verified against rtk/base.obs: G23 L1 -9814.989 -> -10343.618 over
   one second while D1 = +529);
 - D1: the tracked carrier Doppler (positive = approaching), averaged
   over a 0.1 s window centered on the observation block;
 - S1: NWPR C/N0 over a window around each epoch.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from gps_sdr_sim_tpu.constants import CA_SEQ_LEN, CODE_FREQ, SPEED_OF_LIGHT
from gps_sdr_sim_tpu.receiver.navdec import cn0_estimate
from gps_sdr_sim_tpu.receiver.pvt import (_bit_edge_chips, _wrapdiff_arr,
                                          channel_frames)
from gps_sdr_sim_tpu.receiver.track import TrackResult
from gps_sdr_sim_tpu.utils.gpstime import GpsTime, gps2date

# GPS era: subframe 1 carries only the 10 LSBs of the week (the signal
# cannot convey the 1024-week rollover count); era 1 = weeks 1024..2047
# (1999-08 .. 2019-04), right for the bundled 2014 ephemerides.
DEFAULT_ERA = 1


def _hdr(value: str, label: str) -> str:
    return f"{value:<60.60s}{label}\n"


def _transmit_times(res: TrackResult, c: int, off: int, sbf) -> np.ndarray:
    """SV transmit time (s of week) at the start of EVERY block, one
    channel — the vectorized form of pvt.transmit_time."""
    cph = res.code_phase[:, c].astype(np.float64)
    anchor = _bit_edge_chips(res.prompt[:, c], off, cph)
    drift = np.concatenate([[0.0], np.cumsum(_wrapdiff_arr(np.diff(cph)))])
    m = np.arange(len(cph))
    chips = anchor + CA_SEQ_LEN * (m - off) + (drift - drift[off])
    chips_since = chips - sbf.bit_index * 20 * CA_SEQ_LEN
    return (sbf.tow_sec - 6.0) + chips_since / CODE_FREQ


def obs_epochs(res: TrackResult, frames=None, interval: float = 1.0):
    """Form per-epoch RINEX observables from tracked channels.

    Returns (sats, t_obs, C1, L1, D1, S1, week_lsb): arrays over
    [n_epochs, n_sats]; t_obs are whole-interval GPS seconds of week on
    the steered receiver clock.
    """
    if frames is None:
        frames = channel_frames(res)
    chans: List[tuple] = []
    week = None
    for c, prn in enumerate(res.prns):
        off, _bits, sbfs = frames[c]
        if not sbfs:
            continue
        for s in sbfs:
            if s.week is not None:
                week = s.week
        chans.append((c, int(prn), _transmit_times(res, c, off, sbfs[0])))
    if not chans:
        raise ValueError("no channel decoded a subframe; track longer")

    n_ms = res.prompt.shape[0]
    # Steer the nominal receiver clock onto whole seconds: receive time
    # at block m is t0 + m ms with t0 chosen so the first epoch is the
    # first integer second >= max(tx)+68.8 ms nominal flight time.
    t_raw0 = max(tx[0] for _c, _p, tx in chans) + 0.068802
    s0 = float(np.ceil(t_raw0 * (1.0 / interval)) * interval)
    step = int(round(interval * 1000.0))
    m0 = int(round((s0 - t_raw0) * 1000.0))
    ms = np.arange(m0, n_ms, step)
    if ms.size == 0:
        raise ValueError("capture shorter than one observation interval")
    t_obs = s0 + (ms - m0) * 1e-3

    C1 = np.empty((ms.size, len(chans)))
    L1 = np.empty_like(C1)
    D1 = np.empty_like(C1)
    S1 = np.empty_like(C1)
    for j, (c, _prn, tx) in enumerate(chans):
        C1[:, j] = (t_obs - tx[ms]) * SPEED_OF_LIGHT
        dop = res.doppler[:, c].astype(np.float64)
        phase = np.concatenate([[0.0], np.cumsum(dop) * 1e-3])
        # Absolute PLL NCO phase (the accumulator starts at 0 and the
        # Costas loop locks it to the signal carrier modulo half cycles),
        # not zeroed at the first epoch: keeping the absolute value
        # preserves the half-integer double-difference ambiguity
        # structure receiver/rtk.py exploits. dL1/dt = -D1 (RTKCONV).
        L1[:, j] = -phase[ms]
        # D1: mean PLL Doppler over a 0.1 s window CENTERED on each
        # observation block — the unbiased instantaneous Doppler at the
        # epoch (an epoch-aligned window's mean sits at the window
        # center, up to 50 ms away, which under rover dynamics of ~2 Hz/s
        # Doppler rate skews Doppler-based slip prediction by ~0.1 cycle).
        # A hardware receiver's reported Doppler is likewise loop-
        # filtered; the raw per-block NCO frequency carries ~Hz
        # proportional-term jitter (measured: 0.99-cycle worst-case
        # trapezoid misprediction raw vs 0.07 smoothed) that would poison
        # rtk.dopp_slips.
        e0 = np.maximum(ms - 50, 0)
        e1 = np.minimum(ms + 50, n_ms)
        csum = np.concatenate([[0.0], np.cumsum(dop)])
        D1[:, j] = (csum[e1] - csum[e0]) / (e1 - e0)
        for k, m in enumerate(ms):
            lo, hi = max(0, m - 500), min(n_ms, m + 500)
            S1[k, j] = cn0_estimate(res.prompt[lo:hi, c])
    sats = [prn for _c, prn, _tx in chans]
    return sats, t_obs, C1, L1, D1, S1, week


def write_obs(fp, res: TrackResult, frames=None, interval: float = 1.0,
              era: int = DEFAULT_ERA,
              approx_xyz: Optional[np.ndarray] = None,
              marker: str = "GPS-SDR-SIM") -> int:
    """Write a RINEX 2.11 observation file; returns the epoch count."""
    sats, t_obs, C1, L1, D1, S1, week = obs_epochs(res, frames, interval)
    if week is None:
        raise ValueError("no subframe 1 decoded (week unknown); "
                         "track >= 30 s or pass a longer capture")
    wk = week + 1024 * era
    xyz = np.zeros(3) if approx_xyz is None else np.asarray(approx_xyz)

    d0 = gps2date(GpsTime(wk, float(t_obs[0])))
    d1 = gps2date(GpsTime(wk, float(t_obs[-1])))
    fp.write(_hdr("     2.11           OBSERVATION DATA    G (GPS)",
                  "RINEX VERSION / TYPE"))
    fp.write(_hdr("gps-sdr-sim-tpu rx                      "
                  f"{d0.y:04d}{d0.m:02d}{d0.d:02d} 000000 GPS",
                  "PGM / RUN BY / DATE"))
    fp.write(_hdr(marker, "MARKER NAME"))
    fp.write(_hdr("", "OBSERVER / AGENCY"))
    fp.write(_hdr("", "REC # / TYPE / VERS"))
    fp.write(_hdr("", "ANT # / TYPE"))
    fp.write(_hdr(f"{xyz[0]:14.4f}{xyz[1]:14.4f}{xyz[2]:14.4f}",
                  "APPROX POSITION XYZ"))
    fp.write(_hdr(f"{0.0:14.4f}{0.0:14.4f}{0.0:14.4f}",
                  "ANTENNA: DELTA H/E/N"))
    fp.write(_hdr("     1     1", "WAVELENGTH FACT L1/2"))
    fp.write(_hdr("     4    C1    L1    D1    S1", "# / TYPES OF OBSERV"))
    fp.write(_hdr(f"{d0.y:6d}{d0.m:6d}{d0.d:6d}{d0.hh:6d}{d0.mm:6d}"
                  f"{d0.sec:13.7f}{'GPS':>8s}", "TIME OF FIRST OBS"))
    fp.write(_hdr(f"{d1.y:6d}{d1.m:6d}{d1.d:6d}{d1.hh:6d}{d1.mm:6d}"
                  f"{d1.sec:13.7f}{'GPS':>8s}", "TIME OF LAST OBS"))
    fp.write(_hdr("", "END OF HEADER"))

    for k in range(t_obs.size):
        d = gps2date(GpsTime(wk, float(t_obs[k])))
        line = (f" {d.y % 100:2d} {d.m:2d} {d.d:2d} {d.hh:2d} {d.mm:2d}"
                f"{d.sec:11.7f}  0{len(sats):3d}")
        ids = [f"G{p:2d}" for p in sats]
        line += "".join(ids[:12])
        fp.write(line + "\n")
        for chunk in range(12, len(ids), 12):
            fp.write(" " * 32 + "".join(ids[chunk:chunk + 12]) + "\n")
        for j in range(len(sats)):
            ssi = int(np.clip(round(S1[k, j] / 6.0), 1, 9))
            fp.write(f"{C1[k, j]:14.3f}  "
                     f"{L1[k, j]:14.3f} {ssi:1d}"
                     f"{D1[k, j]:14.3f}  "
                     f"{S1[k, j]:14.3f}  \n")
    return t_obs.size


def write_nav(fp, res: TrackResult, frames=None,
              era: int = DEFAULT_ERA) -> int:
    """Write the decoded ephemerides as a RINEX 2.11 GPS nav file.

    The inverse of models/ephemeris.py's parser for the fields the signal
    carries; together with write_obs this reproduces the reference's
    RTKCONV artifact pair (rtk/base.obs + rtk/base.nav) in software.
    Returns the number of ephemeris records written.
    """
    from gps_sdr_sim_tpu.receiver.ephdec import decode_sets

    if frames is None:
        frames = channel_frames(res)

    def e(x: float) -> str:
        """RINEX D19.12 field (the reference data uses D exponents)."""
        s = f"{x:19.12E}"
        mant, exp = s.split("E")
        return f"{mant}D{int(exp):+03d}"

    fp.write(_hdr("     2.11           N: GPS NAV DATA",
                  "RINEX VERSION / TYPE"))
    fp.write(_hdr("gps-sdr-sim-tpu rx", "PGM / RUN BY / DATE"))
    fp.write(_hdr("", "END OF HEADER"))

    n = 0
    for c, prn in enumerate(res.prns):
        _off, _bits, sbfs = frames[c]
        for es in decode_sets(sbfs):
            eph = es.eph
            wk = eph.toc.week + 1024 * era
            d = gps2date(GpsTime(wk, eph.toc.sec))
            fp.write(f"{int(prn):2d} {d.y % 100:02d} {d.m:2d} {d.d:2d} "
                     f"{d.hh:2d} {d.mm:2d}{d.sec:5.1f}"
                     f"{e(eph.af0)}{e(eph.af1)}{e(eph.af2)}\n")
            rows = [
                (eph.iode, eph.crs, eph.deltan, eph.m0),
                (eph.cuc, eph.ecc, eph.cus, eph.sqrta),
                (eph.toe.sec, eph.cic, eph.omg0, eph.cis),
                (eph.inc0, eph.crc, eph.aop, eph.omgdot),
                (eph.idot, eph.codeL2, float(wk), 0.0),
                (0.0, float(eph.svhlth), eph.tgd, float(eph.iodc)),
                (0.0, 0.0, 0.0, 0.0),
            ]
            for row in rows:
                fp.write("   " + "".join(e(float(v)) for v in row) + "\n")
            n += 1
    return n
