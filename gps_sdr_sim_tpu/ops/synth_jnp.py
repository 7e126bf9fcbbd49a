"""XLA IQ synthesis kernel: the one device path, on every platform.

The per-sample hot loop of gpssim.c:2190-2264 re-expressed as a closed-form,
fully data-parallel evaluation over [epochs, sub-blocks, samples], summed
over channels:

 - code-phase / carrier-phase ramps: exact 40-bit fixed point in three
   int32 limbs (see ops/plan.py);
 - C/A chip: chips bit-packed into 32 uint32 words per channel; one table
   lookup fetches the word, one shift+mask extracts the chip;
 - nav data bit: only <= 7 consecutive bits are reachable inside one epoch,
   so the host ships an 8-bit window per (epoch, channel) and the kernel
   shifts into it;
 - sin/cos mixer: a lookup of the exact sinTable512/cosTable512 values
   (gpssim.c:15-83, ops/tables.py), so no float rounding can differ
   between backends.

Everything is int32 except one float32 floor per divide-by-constant, which
is exact for the operand ranges involved (T < 2^24).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr_sim_tpu.constants import CA_SEQ_LEN, SUBBLOCK
from gps_sdr_sim_tpu.ops.plan import DeviceBatch
from gps_sdr_sim_tpu.ops.tables import COS_TABLE512, SIN_TABLE512

_INV1023 = np.float32(1.0 / 1023.0)


def ca_chip(words, chip):
    """Chip `chip` (0..1022) of one channel's [32] bit-packed C/A words, 0/1."""
    word = jnp.take(words, chip >> 5, mode="clip")
    return (word >> (chip & 31)) & 1


def trig_lookup(i_tab):
    """(sinTable512[i_tab], cosTable512[i_tab]) as int32, i_tab in 0..511."""
    return (jnp.take(jnp.asarray(SIN_TABLE512), i_tab, mode="clip"),
            jnp.take(jnp.asarray(COS_TABLE512), i_tab, mode="clip"))


def _channel_contribution(c, code_s, code_p, carr_s, carr_p, t_base, m0, b0,
                          navbits, gain, ca_words):
    """One channel's (I, Q) int32 contribution over [B, SB, R]."""
    r = jnp.arange(SUBBLOCK, dtype=jnp.int32)

    # --- code-phase ramp: three-limb int32 closed form ---
    v0 = code_p[:, :, c, 0, None] + r * code_s[:, None, c, 0, None]
    v1 = code_p[:, :, c, 1, None] + r * code_s[:, None, c, 1, None]
    v2 = code_p[:, :, c, 2, None] + r * code_s[:, None, c, 2, None]
    v1 = v1 + (v0 >> 16)
    v2 = v2 + (v1 >> 16)
    d = v2 >> 8  # chips advanced within the sub-block
    T = t_base[:, :, c, None] + d  # chips since epoch start (< 2^17)

    # --- wrap count and chip index (exact in float32 for T < 2^24) ---
    M = jnp.floor((T.astype(jnp.float32) + 0.5) * _INV1023).astype(jnp.int32)
    chip = T - CA_SEQ_LEN * M
    ca_val = 2 * ca_chip(ca_words[c], chip) - 1

    # --- nav data bit from the per-epoch 8-bit window ---
    mg = m0[:, c, None, None] + M
    bidx = jnp.floor((mg.astype(jnp.float32) + 0.5)
                     * np.float32(1.0 / 20.0)).astype(jnp.int32)
    j = bidx - b0[:, c, None, None]
    bit_val = 2 * ((navbits[:, c, None, None] >> j) & 1) - 1

    # --- carrier-phase ramp -> 9-bit index -> trig tables ---
    w0 = carr_p[:, :, c, 0, None] + r * carr_s[:, None, c, 0, None]
    w1 = carr_p[:, :, c, 1, None] + r * carr_s[:, None, c, 1, None]
    w2 = carr_p[:, :, c, 2, None] + r * carr_s[:, None, c, 2, None]
    w1 = w1 + (w0 >> 16)
    w2 = w2 + (w1 >> 16)
    i_tab = ((w2 << 1) | ((w1 >> 15) & 1)) & 0x1FF
    sin_v, cos_v = trig_lookup(i_tab)

    m = bit_val * ca_val * gain[:, c, None, None]
    return m * cos_v, m * sin_v


def accumulate(code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
               ca_words, *, n_chan: int):
    """Sum the int32 I/Q contributions of `n_chan` channels.

    Returns (iacc, qacc), each [B, SB, SUBBLOCK] int32 — the accumulator of
    gpssim.c:2208-2209 *before* the (acc+64)>>7 quantization. Exposed
    separately so channel-sharded partial sums can be psum-reduced across
    devices first (the reference sums all channels before quantizing,
    gpssim.c:2192-2259, so reduction placement is correctness-relevant).
    """
    args = (code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
            ca_words)

    def body(c, accs):
        ic, qc = _channel_contribution(c, *args)
        return accs[0] + ic, accs[1] + qc

    # Channel 0 seeds the carry (instead of jnp.zeros) so the accumulator
    # inherits the inputs' varying-axes type under shard_map — a zeros init
    # is device-invariant and jax rejects the fori_loop carry mismatch.
    return jax.lax.fori_loop(1, n_chan, body, _channel_contribution(0, *args))


def quantize_iq(iacc, qacc, n_out: int):
    """Reference rounding (acc + 64) >> 7, truncating cast to int16."""
    B, SB, _ = iacc.shape
    i16 = ((iacc + 64) >> 7).astype(jnp.int16).reshape(B, SB * SUBBLOCK)
    q16 = ((qacc + 64) >> 7).astype(jnp.int16).reshape(B, SB * SUBBLOCK)
    return jnp.stack([i16, q16], axis=-1)[:, :n_out]


@lru_cache(maxsize=None)
def _get_synth_fn(n_out: int, n_chan: int):
    @jax.jit
    def synth(code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
              ca_words):
        iacc, qacc = accumulate(
            code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
            ca_words, n_chan=n_chan)
        return quantize_iq(iacc, qacc, n_out)

    return synth


def synth_iq16(code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
               ca_words, *, n_out: int):
    """Synthesize int16 IQ for a batch of epochs; returns [B, n_out, 2]."""
    fn = _get_synth_fn(n_out, int(gain.shape[1]))
    return fn(code_s, code_p, carr_s, carr_p, t_base, m0, b0, navbits, gain,
              ca_words)


def synth_batch(batch: DeviceBatch, n_out: int) -> jax.Array:
    """Convenience wrapper: DeviceBatch -> [B, n_out, 2] int16 on device."""
    return synth_iq16(
        jnp.asarray(batch.code_s), jnp.asarray(batch.code_p),
        jnp.asarray(batch.carr_s), jnp.asarray(batch.carr_p),
        jnp.asarray(batch.t_base), jnp.asarray(batch.m0),
        jnp.asarray(batch.b0), jnp.asarray(batch.navbits),
        jnp.asarray(batch.gain), jnp.asarray(batch.ca_words), n_out=n_out)
