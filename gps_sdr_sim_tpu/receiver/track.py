"""Closed-loop DLL/PLL tracking, vmapped over channels, scanned over time.

Classic scalar GPS tracking (early/prompt/late correlators, normalized
envelope DLL, Costas PLL with carrier-aided code NCO) expressed as one
device program: the per-millisecond update is one pure function of a small
state vector, `jax.vmap` runs every channel in lockstep, and `jax.lax.scan`
unrolls the time axis inside a single compiled program — no data-dependent
Python control flow.

Precision: absolute code phase is kept as (int32 chip index mod 1023,
f32 fractional chip), so no f64 is needed on device; the closed loop
absorbs the f32 NCO rounding (~1e-7 chip/ms) that an open-loop replica
would accumulate over long runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr_sim_tpu.constants import CA_SEQ_LEN, CODE_FREQ
from gps_sdr_sim_tpu.models.cacode import all_codes
from gps_sdr_sim_tpu.receiver.acquire import AcqResult

_EL_SPACING = 0.5  # early/late offset, chips


def _loop_gains(bw: float, T: float, zeta: float = 0.7071):
    """(Ki, Kp) of the PI loop filter: f = basis + Kp*e + Ki*sum(e).

    Standard 2nd-order loop (Kaplan & Hegarty): natural frequency
    w0 = 8*zeta*bw / (4*zeta^2 + 1), Kp = 2*zeta*w0, Ki = w0^2 * T.
    """
    w0 = bw * 8.0 * zeta / (4.0 * zeta * zeta + 1.0)
    return w0 * w0 * T, 2.0 * zeta * w0


@dataclass
class TrackResult:
    prns: np.ndarray        # [C]
    prompt: np.ndarray      # [n_ms, C] complex64 prompt correlator
    doppler: np.ndarray     # [n_ms, C] f32 carrier Doppler estimate (Hz)
    code_phase: np.ndarray  # [n_ms, C] f32 chip index at block start


@lru_cache(maxsize=None)
def _track_fn(s: int, pll_bw: float, dll_bw: float):
    T = 1e-3
    ki_p, kp_p = _loop_gains(pll_bw, T)
    ki_d, kp_d = _loop_gains(dll_bw, T)

    def step(state, x_ms, ca, f_basis, fs):
        # All-real arithmetic (re/im carried separately).
        chip_i, chip_f, carr_ph, f_wipe, i_pll, d_nco, i_dll = state
        x_re, x_im = x_ms
        k = jnp.arange(s, dtype=jnp.float32)

        f_code = CODE_FREQ + f_wipe / 1540.0 + d_nco  # carrier-aided
        code_step = f_code / fs
        cp = chip_f + k * code_step

        def replica(offset):
            j = jnp.remainder(
                chip_i + jnp.floor(cp + offset).astype(jnp.int32),
                CA_SEQ_LEN)
            return ca[j]

        phase = 2.0 * jnp.pi * (carr_ph + k * (f_wipe / fs))
        c, sn = jnp.cos(phase), jnp.sin(phase)
        # y = x * e^{-j phase}
        y_re = x_re * c + x_im * sn
        y_im = x_im * c - x_re * sn

        def corr(code):
            return jnp.sum(y_re * code), jnp.sum(y_im * code)

        e_re, e_im = corr(replica(jnp.float32(+_EL_SPACING)))
        p_re, p_im = corr(replica(jnp.float32(0.0)))
        l_re, l_im = corr(replica(jnp.float32(-_EL_SPACING)))

        # Costas discriminator (cycles), insensitive to nav-bit sign.
        e_pll = jnp.arctan(p_im / (p_re + 1e-12)) / (2.0 * jnp.pi)
        # Normalized non-coherent early-late envelope (chips).
        ae = jnp.sqrt(e_re * e_re + e_im * e_im)
        al = jnp.sqrt(l_re * l_re + l_im * l_im)
        e_dll = 0.5 * (ae - al) / (ae + al + 1e-12)
        P = (p_re, p_im)

        i_pll = i_pll + e_pll
        f_wipe_next = f_basis + kp_p * e_pll + ki_p * i_pll
        i_dll = i_dll + e_dll
        d_nco_next = kp_d * e_dll + ki_d * i_dll

        # Output carries BLOCK-START state (phase before this block's
        # advance) — pvt.transmit_time depends on that convention.
        out = (P[0], P[1], f_wipe, chip_i.astype(jnp.float32) + chip_f)

        # Advance NCOs with the frequencies actually used this block.
        carr_ph = jnp.mod(carr_ph + s * (f_wipe / fs), 1.0)
        total = chip_f + s * code_step
        adv = jnp.floor(total).astype(jnp.int32)
        chip_f = total - adv.astype(jnp.float32)
        chip_i = jnp.remainder(chip_i + adv, CA_SEQ_LEN)

        return (chip_i, chip_f, carr_ph, f_wipe_next, i_pll,
                d_nco_next, i_dll), out

    vstep = jax.vmap(step, in_axes=(0, None, 0, 0, None), out_axes=0)

    @jax.jit
    def run(state0, x_re, x_im, ca, f_basis, fs):
        def body(st, x_ms):
            return vstep(st, x_ms, ca, f_basis, fs)

        _, (p_re, p_im, dop, cph) = jax.lax.scan(body, state0, (x_re, x_im))
        return p_re, p_im, dop, cph

    return run


def track(x: np.ndarray, fs: float, acq: Sequence[AcqResult],
          pll_bw: float = 18.0, dll_bw: float = 2.0) -> TrackResult:
    """Track acquired channels through baseband samples x (complex64)."""
    acq = [a for a in acq if a.detected]
    if not acq:
        raise ValueError("no detected channels to track")
    s = int(round(fs * 1e-3))
    n_ms = len(x) // s
    C = len(acq)

    codes = all_codes().astype(np.float32) * 2 - 1  # [32, 1023] {-1,+1}
    ca = np.stack([codes[a.prn - 1] for a in acq])

    # Acquisition reports the sample offset where the code period starts;
    # convert to chips elapsed since the code start at sample 0.
    chip0 = np.array(
        [(-a.code_phase * CODE_FREQ / fs) % CA_SEQ_LEN for a in acq],
        np.float64)
    chip_i = chip0.astype(np.int32)
    chip_f = (chip0 - chip_i).astype(np.float32)
    f0 = np.array([a.doppler for a in acq], np.float32)

    zeros = np.zeros(C, np.float32)
    x_blocks = np.asarray(x[:n_ms * s], np.complex64).reshape(n_ms, s)
    x_re = np.ascontiguousarray(x_blocks.real, np.float32)
    x_im = np.ascontiguousarray(x_blocks.imag, np.float32)
    run = _track_fn(s, pll_bw, dll_bw)
    state0 = tuple(jnp.asarray(a) for a in
                   (chip_i, chip_f, zeros, f0, zeros, zeros, zeros))
    p_re, p_im, dop, cph = jax.device_get(
        run(state0, jnp.asarray(x_re), jnp.asarray(x_im), jnp.asarray(ca),
            jnp.asarray(f0), jnp.float32(fs)))

    return TrackResult(
        prns=np.array([a.prn for a in acq], np.int32),
        prompt=(p_re + 1j * p_im).astype(np.complex64),
        doppler=dop, code_phase=cph)
