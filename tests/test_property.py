"""Property tests against an independent per-sample NCO transcription.

The golden-file tests (test_iq_golden.py) pin down the canonical scenarios;
these tests pin down the *math*: a direct float64 Python transcription of
the reference's per-sample hot loop (gpssim.c:2190-2264 — sequential NCO
accumulation, wrap/bit/word counters, LUT mix, (acc+64)>>7) must agree
sample-for-sample with the closed-form fixed-point plan + device kernel on
randomized channel states, not just on scenario-derived ones.
"""

import numpy as np
import pytest

from gps_sdr_sim_tpu.constants import CA_SEQ_LEN, CODE_FREQ, MAX_CHAN
from gps_sdr_sim_tpu.models.cacode import codegen
from gps_sdr_sim_tpu.models.navmsg import compute_checksum
from gps_sdr_sim_tpu.models.scenario import Segment
from gps_sdr_sim_tpu.ops.plan import plan_batch
from gps_sdr_sim_tpu.ops.synth_jnp import synth_batch
from gps_sdr_sim_tpu.ops.tables import COS_TABLE512, SIN_TABLE512
from gps_sdr_sim_tpu.receiver.navdec import parity_ok


def naive_epoch_channel(ca01, bits_pm, f_carr, f_code, code_phase0,
                        carr_phase0, m0, gain, n, delt):
    """gpssim.c:2190-2253 for one channel: sequential f64 NCO accumulation."""
    ip = np.zeros(n, np.int64)
    qp = np.zeros(n, np.int64)
    code_phase = code_phase0
    carr_phase = carr_phase0
    icode = m0 % 20
    ibit_global = m0 // 20
    data_bit = int(bits_pm[min(ibit_global, 1799)])
    code_ca = int(ca01[int(code_phase)]) * 2 - 1
    for k in range(n):
        itable = int(np.floor(carr_phase * 512.0))
        ip[k] = data_bit * code_ca * COS_TABLE512[itable] * gain
        qp[k] = data_bit * code_ca * SIN_TABLE512[itable] * gain

        code_phase += f_code * delt
        if code_phase >= CA_SEQ_LEN:
            code_phase -= CA_SEQ_LEN
            icode += 1
            if icode >= 20:
                icode = 0
                ibit_global += 1
                data_bit = int(bits_pm[min(ibit_global, 1799)])
        code_ca = int(ca01[int(code_phase)]) * 2 - 1

        carr_phase += f_carr * delt
        if carr_phase >= 1.0:
            carr_phase -= 1.0
        elif carr_phase < 0.0:
            carr_phase += 1.0
    return ip, qp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_sequential_nco(seed):
    rng = np.random.default_rng(seed)
    fs = 1.0e6
    delt = 1.0 / fs
    n = 100_000  # one 0.1 s epoch at the minimum supported rate
    E, C, active_n = 1, MAX_CHAN, 3

    prns = rng.choice(np.arange(1, 33), size=active_n, replace=False)
    seg = Segment(
        first_epoch=1, n_epochs=E,
        active=np.zeros(C, bool), prn=np.zeros(C, np.int32),
        ca=np.zeros((C, CA_SEQ_LEN), np.int8),
        bits=rng.choice(np.array([-1, 1], np.int8), size=(C, 1800)),
        f_carr=rng.uniform(-5000, 5000, (E, C)),
        f_code=np.zeros((E, C)),
        code_phase0=rng.uniform(0, CA_SEQ_LEN, (E, C)),
        carr_phase0=rng.uniform(0, 1, (E, C)),
        m0=rng.integers(0, 1500 * 20, (E, C)).astype(np.int32),
        gain=rng.integers(50, 200, (E, C)).astype(np.int32),
    )
    seg.f_code[:] = CODE_FREQ + seg.f_carr / 1540.0
    ca01 = np.zeros((C, CA_SEQ_LEN), np.int64)
    for i, prn in enumerate(prns):
        seg.active[i] = True
        seg.prn[i] = prn
        ca01[i] = codegen(int(prn))
        seg.ca[i] = (ca01[i] * 2 - 1).astype(np.int8)

    db = plan_batch(seg, 0, E, n, delt)
    got = np.asarray(synth_batch(db, n))  # [E, n, 2] int16

    iacc = np.zeros(n, np.int64)
    qacc = np.zeros(n, np.int64)
    for i in range(active_n):
        ip, qp = naive_epoch_channel(
            ca01[i], seg.bits[i], seg.f_carr[0, i], seg.f_code[0, i],
            seg.code_phase0[0, i], seg.carr_phase0[0, i],
            int(seg.m0[0, i]), int(seg.gain[0, i]), n, delt)
        iacc += ip
        qacc += qp
    want_i = ((iacc + 64) >> 7).astype(np.int16)
    want_q = ((qacc + 64) >> 7).astype(np.int16)

    # The sequential f64 accumulation and the exact closed form may pick
    # different LUT indices/chips for a handful of razor's-edge samples —
    # the same budget the C oracle itself is held to.
    d_i = np.abs(got[0, :, 0].astype(np.int32) - want_i.astype(np.int32))
    d_q = np.abs(got[0, :, 1].astype(np.int32) - want_q.astype(np.int32))
    frac = (np.count_nonzero(d_i) + np.count_nonzero(d_q)) / (2 * n)
    assert frac <= 1e-4, frac
    assert max(d_i.max(), d_q.max()) <= 4


@pytest.mark.parametrize("seed", [0, 3])
def test_kernel_matches_sequential_fixed_nco(seed):
    """Fixed carrier mode (FLOAT_CARR_PHASE undefined): the reference's
    32-bit NCO (gpssim.c:2175-2177,2251-2252) is exact integer arithmetic,
    so the kernel's carrier indices must match it bit-for-bit; residual
    mismatches can come only from the (still float) code phase."""
    rng = np.random.default_rng(seed)
    fs = 1.0e6
    delt = 1.0 / fs
    n = 100_000
    E, C, active_n = 1, MAX_CHAN, 3

    prns = rng.choice(np.arange(1, 33), size=active_n, replace=False)
    seg = Segment(
        first_epoch=1, n_epochs=E,
        active=np.zeros(C, bool), prn=np.zeros(C, np.int32),
        ca=np.zeros((C, CA_SEQ_LEN), np.int8),
        bits=rng.choice(np.array([-1, 1], np.int8), size=(C, 1800)),
        f_carr=rng.uniform(-5000, 5000, (E, C)),
        f_code=np.zeros((E, C)),
        code_phase0=rng.uniform(0, CA_SEQ_LEN, (E, C)),
        carr_phase0=rng.integers(0, 1 << 25, (E, C)) / float(1 << 25),
        m0=rng.integers(0, 1500 * 20, (E, C)).astype(np.int32),
        gain=rng.integers(50, 200, (E, C)).astype(np.int32),
        carr_fixed=True,
    )
    seg.f_code[:] = CODE_FREQ + seg.f_carr / 1540.0
    ca01 = np.zeros((C, CA_SEQ_LEN), np.int64)
    for i, prn in enumerate(prns):
        seg.active[i] = True
        seg.prn[i] = prn
        ca01[i] = codegen(int(prn))
        seg.ca[i] = (ca01[i] * 2 - 1).astype(np.int8)

    db = plan_batch(seg, 0, E, n, delt)
    got = np.asarray(synth_batch(db, n))

    iacc = np.zeros(n, np.int64)
    qacc = np.zeros(n, np.int64)
    for i in range(active_n):
        ip, qp = naive_epoch_channel_fixed(
            ca01[i], seg.bits[i], seg.f_carr[0, i], seg.f_code[0, i],
            seg.code_phase0[0, i], int(seg.carr_phase0[0, i] * (1 << 25)),
            int(seg.m0[0, i]), int(seg.gain[0, i]), n, delt)
        iacc += ip
        qacc += qp
    want_i = ((iacc + 64) >> 7).astype(np.int16)
    want_q = ((qacc + 64) >> 7).astype(np.int16)

    d_i = np.abs(got[0, :, 0].astype(np.int32) - want_i.astype(np.int32))
    d_q = np.abs(got[0, :, 1].astype(np.int32) - want_q.astype(np.int32))
    frac = (np.count_nonzero(d_i) + np.count_nonzero(d_q)) / (2 * n)
    assert frac <= 1e-4, frac
    assert max(d_i.max(), d_q.max()) <= 4


def naive_epoch_channel_fixed(ca01, bits_pm, f_carr, f_code, code_phase0,
                              carr_phase_u, m0, gain, n, delt):
    """The hot loop with FLOAT_CARR_PHASE undefined: unsigned 32-bit
    carrier accumulator, step (int)round(2^25 f_carr delt)."""
    import math

    ip = np.zeros(n, np.int64)
    qp = np.zeros(n, np.int64)
    step = int(math.copysign(math.floor(abs(512.0 * 65536.0 * f_carr * delt)
                                        + 0.5), f_carr))
    code_phase = code_phase0
    icode = m0 % 20
    ibit_global = m0 // 20
    data_bit = int(bits_pm[min(ibit_global, 1799)])
    code_ca = int(ca01[int(code_phase)]) * 2 - 1
    for k in range(n):
        itable = (carr_phase_u >> 16) & 0x1FF
        ip[k] = data_bit * code_ca * COS_TABLE512[itable] * gain
        qp[k] = data_bit * code_ca * SIN_TABLE512[itable] * gain

        code_phase += f_code * delt
        if code_phase >= CA_SEQ_LEN:
            code_phase -= CA_SEQ_LEN
            icode += 1
            if icode >= 20:
                icode = 0
                ibit_global += 1
                data_bit = int(bits_pm[min(ibit_global, 1799)])
        code_ca = int(ca01[int(code_phase)]) * 2 - 1

        carr_phase_u = (carr_phase_u + step) & 0xFFFFFFFF
    return ip, qp


@pytest.mark.parametrize("seed", [0, 1])
def test_parity_roundtrip_random_words(seed):
    """parity_ok must accept every word compute_checksum emits."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        data = int(rng.integers(0, 1 << 24)) << 6
        d29, d30 = int(rng.integers(0, 2)), int(rng.integers(0, 2))
        word = compute_checksum((d29 << 31) | (d30 << 30) | data, nib=False)
        assert parity_ok(word, d29, d30)
        # Any single-bit flip must be rejected.
        bit = int(rng.integers(0, 30))
        assert not parity_ok(word ^ (1 << bit), d29, d30)
