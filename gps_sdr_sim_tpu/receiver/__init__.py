"""Software GPS L1 C/A receiver: the framework's hardware-free validation
path.

The reference validates its synthesized signal by feeding SDR hardware into
real receivers (u-center.png, ublox.jpg, rtk/ RTKLIB datasets — see
SURVEY.md §4). Having no hardware in the loop, this package closes the same
loop in software, as device programs: FFT parallel code-phase acquisition
(acquire.py), vmapped DLL/PLL tracking as a lax.scan (track.py), and
nav-message bit/frame sync + IS-GPS-200 parity-checked decode (navdec.py).

A full end-to-end check — synthesize a scenario, acquire every visible PRN,
track, decode the 50 bps stream, and compare it bit-for-bit with the
transmitted nav message — runs in tests/test_receiver.py.
"""

from gps_sdr_sim_tpu.receiver.frontend import load_iq
from gps_sdr_sim_tpu.receiver.acquire import acquire
from gps_sdr_sim_tpu.receiver.track import track
from gps_sdr_sim_tpu.receiver.navdec import (
    bit_sync,
    decode_bits,
    frame_sync,
    parity_ok,
)

__all__ = ["load_iq", "acquire", "track", "bit_sync",
           "decode_bits", "frame_sync", "parity_ok"]
