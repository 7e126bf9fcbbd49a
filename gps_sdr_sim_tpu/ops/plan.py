"""Host -> device batch preparation: exact fixed-point phase-ramp params.

The reference's hot loop advances two float64 NCOs (code chips and carrier
cycles) one sample at a time (gpssim.c:2212-2252). Instead of iterating, we
evaluate the phase ramps in closed form with an exact integer
decomposition, so every backend computes the same bits:

  phase(k0 + r) = (P + r*S) / 2^40   (r < SUBBLOCK)

where P (the sub-block base phase, accumulated in exact integer arithmetic
from the epoch-start phase and the 2^56-quantized step) and S (bits
[16, 64) of that same step) are split into three 16-bit limbs covering
fractional bits [16, 56). In-kernel arithmetic is pure int32: with
r < 2^11 and limbs < 2^16, every partial product stays under 2^27 and
every carry chain under 2^31. Quantization effects vs the true f64 ramp:
step drift < 2^18 * 2^-57 ~ 1e-12 per epoch, plus an unaccumulated
< 2^-29 in-sub-block truncation -- both far below the C oracle's own
f64-NCO noise, so chip boundaries and table indices match the oracle
within the documented golden budget.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gps_sdr_sim_tpu.constants import (
    CA_SEQ_LEN,
    MAX_CHAN,
    PHASE_FRAC_BITS,
    SUBBLOCK,
)
from gps_sdr_sim_tpu.models.scenario import Segment
from gps_sdr_sim_tpu.utils.cstd import c_round

_SCALE = float(1 << PHASE_FRAC_BITS)
_MASK40 = (1 << PHASE_FRAC_BITS) - 1
_SCALE56 = float(1 << 56)
_MASK56 = (1 << 56) - 1
_SCALE25 = float(1 << 25)


def _code_step56(f_code: np.ndarray, delt: float) -> np.ndarray:
    """Code step (chips/sample) quantized once at 2^56, int64.

    This single rounding is THE step the kernel consumes: the
    per-sub-block rebase in plan_batch accumulates all 56 fractional bits
    exactly, and the in-kernel per-sample ramp uses bits [16, 64) —
    dropping the low 16 bits costs < 2^11 * 2^-40 ~ 2^-29 chips within a
    sub-block, never accumulated. Step quantization drift over a whole
    epoch is < 2^18 * 2^-57 ~ 1e-12 chips, far below the C oracle's own
    f64-NCO noise.
    """
    return np.rint(f_code * delt * _SCALE56).astype(np.int64)


def _carr_step56(f_carr: np.ndarray, delt: float, fixed: bool) -> np.ndarray:
    """Carrier step (cycles/sample) quantized at 2^56, in [0, 2^56), int64.

    float mode: the reference's f64 accumulate-and-wrap (gpssim.c:2244-2250)
    quantized at 2^56 (a step rounding up to exactly 2^56 is congruent to 0
    and wraps). fixed mode: the reference's 32-bit NCO (FLOAT_CARR_PHASE
    undefined) steps by round(2^25 * f_carr * delt) counts of 2^-25 cycles
    (gpssim.c:2175-2177); only the phase mod 2^25 reaches the 9-bit table
    index ((carr_phase >> 16) & 0x1ff, gpssim.c:2202), so the wrapping
    32-bit add reduces exactly to this mod-2^25 ramp, scaled by 2^31 into
    the 2^56 domain -- bit-exact vs the C NCO.
    """
    if fixed:
        s25 = c_round(f_carr * delt * _SCALE25).astype(np.int64) % (1 << 25)
        return s25 << 31
    step = np.mod(f_carr * delt, 1.0)
    return np.rint(step * _SCALE56).astype(np.int64) & _MASK56


@dataclass
class DeviceBatch:
    """Device inputs for B consecutive epochs of one segment.

    C/A chips are bit-packed into 32 uint32 words per channel (the kernel
    looks up a word, then shifts out the chip), and nav data
    bits are reduced to the <= 7-bit window actually reachable within one
    0.1 s epoch (one code wrap per ms, 20 ms per bit), shipped as an 8-bit
    word per (epoch, channel).
    """

    code_s: np.ndarray  # [B, C, 3] int32 code-step limbs
    carr_s: np.ndarray  # [B, C, 3] int32 carrier-step limbs
    code_p: np.ndarray  # [B, SB, C, 3] int32 code-phase base limbs
    carr_p: np.ndarray  # [B, SB, C, 3] int32 carrier-phase base limbs
    t_base: np.ndarray  # [B, SB, C] int32 integer chips since epoch start
    m0: np.ndarray  # [B, C] int32 nav ms counter at epoch start
    b0: np.ndarray  # [B, C] int32 nav bit index at epoch start (m0 // 20)
    navbits: np.ndarray  # [B, C] int32: bit j = nav bit (b0 + j), 0/1
    gain: np.ndarray  # [B, C] int32 (0 for inactive channels)
    ca_words: np.ndarray  # [C, 32] int32 bit-packed chips (bit=1 -> +1 chip)

    @property
    def shape(self):
        return self.code_p.shape[:3]


def _limbs(x: np.ndarray) -> np.ndarray:
    """Split int64 values (< 2^48) into three 16-bit limbs, int32."""
    out = np.empty(x.shape + (3,), dtype=np.int32)
    out[..., 0] = (x & 0xFFFF).astype(np.int32)
    out[..., 1] = ((x >> 16) & 0xFFFF).astype(np.int32)
    out[..., 2] = (x >> 32).astype(np.int32)
    return out


def _pack_navbits(bits_pm1: np.ndarray, m0: np.ndarray):
    """(b0, navbits): the 8-bit nav window per (epoch, channel).

    Within one epoch the ms counter advances by at most ~103 wraps, so bit
    indices span [m0//20, (m0+103)//20] — at most 7 values; pack 8 bits
    starting at b0 into one int per (epoch, channel).
    """
    b0 = m0 // 20
    bit01 = (bits_pm1 + 1) // 2  # {-1,+1} -> {0,1}, [C, 1800]
    j = np.arange(8, dtype=np.int64)
    bidx = np.minimum(b0[..., None] + j, 1799)
    window = np.take_along_axis(
        np.broadcast_to(bit01[None], (m0.shape[0],) + bit01.shape),
        bidx, axis=2)
    navbits = np.sum(window.astype(np.int64) << j, axis=-1).astype(np.int32)
    return b0, navbits


def _pack_ca_words(ca_pm1: np.ndarray) -> np.ndarray:
    """[C, 1023] chips in {-1,+1} -> [C, 32] int32, bit k of word w =
    chip 32*w + k (the kernel looks up words, then shifts out bits)."""
    key = ca_pm1.tobytes()
    cached = _CA_WORDS_CACHE.get(key)
    if cached is not None:
        return cached
    chip01 = ((ca_pm1 + 1) // 2).astype(np.int64)
    padded = np.zeros((chip01.shape[0], 1024), dtype=np.int64)
    padded[:, :CA_SEQ_LEN] = chip01
    k = np.arange(32, dtype=np.int64)
    words = np.sum(padded.reshape(-1, 32, 32) << k, axis=-1)
    words = words.astype(np.uint32).view(np.int32)
    if len(_CA_WORDS_CACHE) > 64:
        _CA_WORDS_CACHE.clear()
    _CA_WORDS_CACHE[key] = words
    return words


_CA_WORDS_CACHE: dict = {}


# Fields whose leading axis is NOT the epoch axis (ca_words is [C, 32]);
# they must pass through pad_epoch_axis untouched even when the channel
# count happens to equal the unpadded epoch count.
_NON_EPOCH_FIELDS = frozenset({"ca_words"})


def pad_epoch_axis(batch, target_b: int):
    """Pad any epoch-batch dataclass to `target_b` epochs.

    Arrays whose leading axis is the epoch axis are edge-replicated —
    except `gain`, which is zero-padded so padded epochs synthesize
    silence; everything else (per-segment tables, scalars) passes through.
    """
    import dataclasses

    b = batch.gain.shape[0]
    if b == target_b:
        return batch
    pad = target_b - b
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if (f.name not in _NON_EPOCH_FIELDS and isinstance(v, np.ndarray)
                and v.ndim >= 1 and v.shape[0] == b):
            if f.name == "gain":
                out[f.name] = np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
            else:
                out[f.name] = np.pad(
                    v, [(0, pad)] + [(0, 0)] * (v.ndim - 1), mode="edge")
        else:
            out[f.name] = v
    return type(batch)(**out)


def plan_batch(seg: Segment, e0: int, e1: int, iq_buff_size: int,
               delt: float) -> DeviceBatch:
    """Prepare epochs [e0, e1) of `seg` (segment-local indices)."""
    B = e1 - e0
    C = MAX_CHAN
    SB = -(-iq_buff_size // SUBBLOCK)  # ceil
    k0 = (np.arange(SB, dtype=np.int64) * SUBBLOCK)[None, :, None]  # [1,SB,1]

    s_code = _code_step56(seg.f_code[e0:e1], delt)  # [B, C] int64
    s_carr = _carr_step56(seg.f_carr[e0:e1], delt, seg.carr_fixed)

    # Sub-block bases by EXACT integer accumulation of the 2^56 step, via
    # a 16/40-bit split so k0 * step never overflows int64: base limbs =
    # bits [16, 56), integer carry = bits >= 56.
    def accum(frac56, s56):
        lo = (frac56 & 0xFFFF)[:, None, :] + k0 * (s56 & 0xFFFF)[:, None, :]
        hi = ((frac56 >> 16)[:, None, :] + k0 * (s56 >> 16)[:, None, :]
              + (lo >> 16))  # units of 2^-40
        return hi & _MASK40, hi >> PHASE_FRAC_BITS

    cp0 = seg.code_phase0[e0:e1]
    c_int = np.floor(cp0)
    base_c, carry_c = accum(((cp0 - c_int) * _SCALE56).astype(np.int64),
                            s_code)
    t_base = (c_int.astype(np.int64)[:, None, :] + carry_c).astype(np.int32)
    code_p = _limbs(base_c)

    gp0 = seg.carr_phase0[e0:e1]
    base_g, _ = accum(((gp0 - np.floor(gp0)) * _SCALE56).astype(np.int64),
                      s_carr)
    carr_p = _limbs(base_g)

    gain = (seg.gain[e0:e1] * seg.active[None, :]).astype(np.int32)

    m0 = seg.m0[e0:e1].astype(np.int64)
    b0, navbits = _pack_navbits(seg.bits, m0)
    ca_words = _pack_ca_words(seg.ca)

    return DeviceBatch(
        # In-kernel per-sample steps: bits [16, 64) of the 2^56 step.
        code_s=_limbs(s_code >> 16),
        carr_s=_limbs(s_carr >> 16),
        code_p=code_p,
        carr_p=carr_p,
        t_base=t_base,
        m0=m0.astype(np.int32),
        b0=b0.astype(np.int32),
        navbits=navbits,
        gain=gain,
        ca_words=ca_words,
    )
