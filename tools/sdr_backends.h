// SDR transmit backends for gps-sdr-player.
//
// Each backend exposes the same pull-free sink contract as the file/null
// backends (playerfmt.h pf_sink_fn): the format pipeline pushes converted
// int16 interleaved I/Q buffers, the backend hands them to the vendor
// stack. Vendor libraries are compile-gated — `make -C tools` probes
// pkg-config and defines HAVE_LIBBLADERF / HAVE_LIBHACKRF / HAVE_LIMESUITE
// / HAVE_LIBIIO; selecting a backend whose SDK was absent at build time
// fails with a clear message (no SDR hardware/SDKs exist in the build
// environment, so `file`/`null` are the testable targets — the complete
// vendor client code still lives behind each guard, mirroring the
// reference players).
//
// Reference behaviors mirrored (player/*.c):
//   bladerf: SC16_Q11 sync TX, 32 buffers x 32k samples, 2.6 Msps,
//            1575.42 MHz (bladeplayer.c:15-24,197-203)
//   hackrf:  async tx_callback pulling 8-bit I/Q, sync-wrapped behind a
//            ring buffer; amp on, manual sample rate, filter BW rounded
//            down below the rate (hackplayer.c:53-72,118-196)
//   lime:    native 12-bit LMS_FMT_I12 stream, RX0-enable LimeSuite bug
//            workaround, normalized-gain clamp, per-100-block link-rate
//            report (limeplayer.c:158-163,215-218,275,296-303)
//   pluto:   libiio network context, AD9361 LO/BW/rate/attenuation with
//            the reference's -a/-b clamping, iio_buffer_push
//            (plutoplayer.c:66-106,175-230)

#ifndef GPS_SDR_PLAYER_SDR_BACKENDS_H_
#define GPS_SDR_PLAYER_SDR_BACKENDS_H_

#include <stdint.h>
#include <stddef.h>

struct SdrConfig {
  double frequency_hz = 1575.42e6;
  double sample_rate_hz = 2.6e6;
  double bandwidth_hz = 2.5e6;
  int tx_gain = -25;       // bladeRF txvga1 dB (bladeplayer.c:24)
  double gain_norm = 1.0;  // lime normalized gain (limeplayer.c:82,158-163)
  int channel = 0;         // lime TX channel (limeplayer.c:127-129)
  double atten_db = -20.0;  // pluto hardware gain dB (plutoplayer.c:70)
  const char* pluto_addr = nullptr;  // pluto network context (-n ip)
  // Pipeline value domain, so byte-oriented backends can recover the
  // 8-bit wire scale: 16-bit input arrives right-shifted by
  // rescale_shift, 8-bit input left-shifted by it, 1-bit input expanded
  // to +-amplitude (player_main.cpp -b/-s).
  int input_bits = 16;
  int rescale_shift = 0;
};

struct SdrBackend {
  // Returns nullptr + message on failure. `user` is backend state.
  void* (*open)(const SdrConfig& cfg, const char** error);
  int (*send)(const int16_t* values, size_t n_values, void* user);
  void (*close)(void* user);
  const char* name;
  bool available;  // SDK present at build time
};

// Look up a backend by name ("bladerf", "hackrf", "lime", "pluto").
// Returns nullptr for unknown names.
const SdrBackend* sdr_backend(const char* name);

// --- Option validation, mirrored from the reference players. Compiled
// unconditionally (no SDK needed) so the clamping rules are unit-testable
// without hardware; the gated vendor code above routes through them. ---
extern "C" {
// Lime normalized gain into [0.0, 1.0] (limeplayer.c:158-163).
double sdr_lime_clamp_gain(double gain);
// Lime 1-bit expansion amplitude: values above 2047 clamp (limeplayer.c:138-140).
long sdr_lime_clamp_dynamic(long dynamic);
// Lime TX channel into [0, channel_count) with 0 fallback (limeplayer.c:183-189).
int sdr_lime_clamp_channel(int channel, int channel_count);
// Pluto TX attenuation into [-80, 0] dB (plutoplayer.c:84-86).
double sdr_pluto_clamp_atten(double gain_db);
// Pluto RF bandwidth in Hz into [1, 5] MHz (plutoplayer.c:89-91).
double sdr_pluto_clamp_bw(double bw_hz);
// HackRF baseband filter bandwidth: the largest valid AD/MAX283x filter
// below the sample rate (hackrf_compute_baseband_filter_bw_round_down_lt
// semantics, hackplayer.c:118).
uint32_t sdr_hackrf_filter_bw(uint32_t sample_rate_hz);
}

#endif  // GPS_SDR_PLAYER_SDR_BACKENDS_H_
