"""The synthesis kernel's lookups and the format packers, against the C
reference's own tables and a NumPy transcription of its output loop."""

import jax.numpy as jnp
import numpy as np
import pytest

from gps_sdr_sim_tpu.constants import SUBBLOCK
from gps_sdr_sim_tpu.models.cacode import codegen
from gps_sdr_sim_tpu.ops.plan import _pack_ca_words
from gps_sdr_sim_tpu.ops.quantize import pack
from gps_sdr_sim_tpu.ops.synth_jnp import ca_chip, quantize_iq, trig_lookup


@pytest.mark.parametrize("which", ["sin", "cos"])
def test_trig_lookup_matches_c_tables(golden, which):
    """All 512 entries of sinTable512/cosTable512 (gpssim.c:15-83), as the
    kernel reads them, against the values dumped from the C reference."""
    want = np.array([int(v) for ln in golden["trig"]
                     if ln.split()[0] == which for v in ln.split()[1:]])
    assert want.shape == (512,)
    sin_v, cos_v = trig_lookup(jnp.arange(512, dtype=jnp.int32))
    got = np.asarray(sin_v if which == "sin" else cos_v)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prn", range(1, 33))
def test_ca_chip_lookup_matches_codegen(prn):
    """Every chip of every PRN's C/A code, through the planner's bit-packed
    words and the kernel's word lookup + shift."""
    chips01 = codegen(prn)
    words = _pack_ca_words((2 * chips01 - 1).astype(np.int8)[None])[0]
    got = np.asarray(ca_chip(jnp.asarray(words),
                             jnp.arange(1023, dtype=jnp.int32)))
    np.testing.assert_array_equal(got, chips01)


def _reference_bytes(iacc: np.ndarray, qacc: np.ndarray, n: int,
                     fmt: int) -> bytes:
    """gpssim.c:2258-2288 transcribed for one epoch of n samples: the
    (short)((acc+64)>>7) store, then the bytes fwrite emits for the
    format. C's narrowing casts wrap (two's complement)."""
    def wrap(v, bits):
        return ((v + (1 << (bits - 1))) % (1 << bits)) - (1 << (bits - 1))

    buf = []
    for i, q in zip(iacc[:n].tolist(), qacc[:n].tolist()):
        buf += [wrap((i + 64) >> 7, 16), wrap((q + 64) >> 7, 16)]
    if fmt == 16:
        return np.array(buf, np.int16).tobytes()
    if fmt == 8:  # (signed char)(iq_buff[k] >> 4)
        return np.array([wrap(v >> 4, 8) for v in buf], np.int8).tobytes()
    # SC01: 2*iq_buff_size/8 bytes; byte j holds values 8j..8j+7, MSB
    # first, bit set where the value is > 0. A trailing partial group of
    # < 4 IQ pairs is not written.
    return bytes(sum(128 >> b for b in range(8) if buf[8 * j + b] > 0)
                 for j in range(2 * n // 8))


@pytest.mark.parametrize("fmt", [16, 8, 1])
def test_quantize_and_pack_match_reference_loop(fmt):
    """Per format, from raw channel-sum accumulators: accumulators beyond
    the int16 range after >>7 (the cast wraps), negatives through SC08's
    arithmetic shift, and 4*25+3 samples so SC01 drops a partial group."""
    rng = np.random.default_rng(fmt)
    n = 4 * 25 + 3
    iacc = rng.integers(-300_000, 300_000, (2, 1, SUBBLOCK)).astype(np.int32)
    qacc = rng.integers(-300_000, 300_000, (2, 1, SUBBLOCK)).astype(np.int32)
    iacc[0, 0, :6] = [2**22, -2**22 - 64, 2**31 - 65, -2**31, -65, 63]
    got = np.asarray(pack(quantize_iq(jnp.asarray(iacc), jnp.asarray(qacc),
                                      n), fmt))
    for e in range(2):
        assert got[e].tobytes() == _reference_bytes(
            iacc[e].reshape(-1), qacc[e].reshape(-1), n, fmt)
