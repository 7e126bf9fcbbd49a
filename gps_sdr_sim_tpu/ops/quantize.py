"""Output sample-format packing: SC16 / SC08 / SC01.

Parity targets (gpssim.c:2266-2288):
 - SC16: int16 I/Q pairs as-is.
 - SC08: arithmetic >> 4 of each int16 sample (12-bit bladeRF -> 8-bit).
 - SC01: the sign bit (sample > 0) of each interleaved I/Q value packed
   MSB-first, 4 IQ pairs per byte: {I0,Q0,I1,Q1,I2,Q2,I3,Q3}.

All packing runs on-device so only the final bytes cross PCIe. Outputs keep
the [B, N, 2] shape where possible -- it is bytewise identical to the
interleaved [B, 2N] stream, and XLA:CPU pathologically slow-compiles int8
reshapes (~77 s) that would otherwise be no-ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_BIT_WEIGHTS = np.array([128, 64, 32, 16, 8, 4, 2, 1], dtype=np.int32)


@jax.jit
def pack_sc16(iq: jax.Array) -> jax.Array:
    """[B, N, 2] int16 -> int16 interleaved I/Q (layout already correct)."""
    return iq


@jax.jit
def pack_sc08(iq: jax.Array) -> jax.Array:
    """[B, N, 2] int16 -> int8 via arithmetic >> 4."""
    return (iq >> 4).astype(jnp.int8)


@jax.jit
def pack_sc01(iq: jax.Array) -> jax.Array:
    """[B, N, 2] int16 -> [B, N//4] uint8, sign bits packed MSB-first.

    Like the reference (gpssim.c:2266-2276, loop bound iq_buff_size/4),
    a trailing partial group of <4 IQ pairs is dropped.
    """
    b, n, _ = iq.shape
    n4 = n // 4
    bits = (iq[:, :n4 * 4] > 0).reshape(b, n4, 8).astype(jnp.int32)
    return jnp.sum(bits * _BIT_WEIGHTS, axis=-1).astype(jnp.uint8)


def pack(iq: jax.Array, data_format: int) -> jax.Array:
    if data_format == 16:
        return pack_sc16(iq)
    if data_format == 8:
        return pack_sc08(iq)
    if data_format == 1:
        return pack_sc01(iq)
    raise ValueError(f"Invalid I/Q data format: {data_format}")
