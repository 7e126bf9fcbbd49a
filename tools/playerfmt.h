// playerfmt: sample-format conversion + block streaming shared by all
// SDR playback tools.
//
// Rebuild of the format handling common to the reference's
// player suite (player/bladeplayer.c, hackplayer.c, limeplayer.c,
// plutoplayer.c): 1-bit LUT expansion (bladeplayer.c:190-194,246-253),
// 16->12 / 8->12 / 16->8 rescaling (limeplayer.c:304-342), and the
// INIT/READ/PAD_TRAILING/DONE block streaming state machine
// (bladeplayer.c:218-295). Exposed with a C ABI so the Python framework
// can drive it via ctypes.

#ifndef GPS_SDR_SIM_PLAYERFMT_H_
#define GPS_SDR_SIM_PLAYERFMT_H_

#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

#ifdef __cplusplus
extern "C" {
#endif

// ---- Sample-format conversions (all layouts are interleaved I/Q) ----

// Expand packed 1-bit samples to int16 +-amplitude. Bit layout matches the
// generator's SC01 packing (gpssim.c:2266-2277): each byte holds
// {I0,Q0,I1,Q1,I2,Q2,I3,Q3} MSB-first; a set bit is a positive sample.
// out must hold 8 * n_bytes int16 values.
void pf_expand_1bit(const uint8_t* in, size_t n_bytes, int16_t amplitude,
                    int16_t* out);

// Arithmetic right shift of int16 samples (16-bit file -> 12-bit DAC,
// limeplayer.c:304-313; 16-bit -> 8-bit uses shift=4 into pf_narrow16to8).
void pf_shift16(const int16_t* in, size_t n, int shift_right, int16_t* out);

// Widen int8 samples with a left shift (8-bit file -> 12-bit DAC,
// limeplayer.c:336-342).
void pf_widen8(const int8_t* in, size_t n, int shift_left, int16_t* out);

// Narrow int16 samples to int8 with an arithmetic right shift (the
// generator's own 16->8 rule, gpssim.c:2278-2284).
void pf_narrow16to8(const int16_t* in, size_t n, int shift_right,
                    int8_t* out);

// ---- Block streaming state machine ----

typedef enum {
  PF_STREAM_INIT = 0,
  PF_STREAM_READ = 1,
  PF_STREAM_PAD_TRAILING = 2,
  PF_STREAM_DONE = 3,
} pf_stream_state;

// Sink invoked once per full buffer of converted int16 I/Q values
// (n_values = 2 * samples). Returns 0 to continue, nonzero to abort.
typedef int (*pf_sink_fn)(const int16_t* values, size_t n_values,
                          void* user);

// Pump `in` through format conversion into fixed `buf_samples`-sample
// buffers, zero-padding the trailing partial buffer (so the last real
// samples are still transmitted, bladeplayer.c:262-276).
//   in_bits: 1, 8 or 16 (file sample format)
//   out_shift: right shift applied to 16-bit input (0 or 4); left shift
//              applied to 8-bit input (0 or 4); ignored for 1-bit
//   amplitude: expansion amplitude for 1-bit input
// Returns 0 on success (DONE reached), nonzero on read/sink error.
int pf_stream(FILE* in, int in_bits, int out_shift, int16_t amplitude,
              size_t buf_samples, pf_sink_fn sink, void* user);

#ifdef __cplusplus
}
#endif

#endif  // GPS_SDR_SIM_PLAYERFMT_H_
