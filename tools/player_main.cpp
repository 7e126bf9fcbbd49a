// gps-sdr-player: stream a generated I/Q file through format conversion to
// an output backend.
//
// Unified replacement for the reference's per-vendor players
// (player/bladeplayer.c, hackplayer.c, limeplayer.c, plutoplayer.c): the
// format pipeline (1/8/16-bit input, 12-bit DAC rescale, 1-bit LUT
// expansion, trailing-block padding) is identical; the radio backends are
// compile-gated because no SDR SDK/hardware exists in the build environment.
// The always-available backends are `file` (converted int16 stream, the
// testable target) and `null` (throughput measurement).
//
// Usage:
//   gps-sdr-player -f <input|-> [-b 1|8|16] [-s shift] [-a amplitude]
//                  [-n buf_samples] [-B file|null] [-o output|-]

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <string>

#include "playerfmt.h"
#include "sdr_backends.h"

namespace {

struct FileSink {
  FILE* fp;
  size_t values_written = 0;
};

int write_sink(const int16_t* values, size_t n_values, void* user) {
  auto* s = static_cast<FileSink*>(user);
  if (s->fp != nullptr &&
      fwrite(values, sizeof(int16_t), n_values, s->fp) != n_values) {
    return 1;
  }
  s->values_written += n_values;
  return 0;
}

void usage() {
  fprintf(stderr,
          "Usage: gps-sdr-player [options]\n"
          "  -f <file>   input I/Q file ('-' for stdin; required)\n"
          "  -b <bits>   input sample format: 1, 8 or 16 (default: 16)\n"
          "  -s <shift>  rescale shift: right for 16-bit in, left for 8-bit"
          " in (default: 0; use 4 for a 12-bit DAC)\n"
          "  -a <amp>    1-bit expansion amplitude (default: 2047)\n"
          "  -n <samp>   buffer size in samples (default: 32768)\n"
          "  -B <name>   backend: file, null, bladerf, hackrf, lime,"
          " pluto (default: file;\n"
          "              vendor backends need their SDK at build time)\n"
          "  -o <file>   backend=file output path ('-' for stdout)\n"
          "  -F <hz>     TX center frequency (default: 1575420000)\n"
          "  -r <hz>     TX sample rate (default: 2600000)\n"
          "  -g <gain>   TX gain, vendor units (default: -25)\n"
          "  -c <chan>   lime: TX channel (default: 0)\n"
          "  -G <gain>   lime: normalized gain 0.0-1.0 (default: 1.0)\n"
          "  -A <db>     pluto: TX attenuation, clamped to [-80, 0]"
          " (default: -20)\n"
          "  -w <mhz>    pluto: RF bandwidth, clamped to [1, 5] MHz"
          " (default: 2.5)\n"
          "  -N <addr>   pluto: network context address"
          " (default: pluto.local)\n");
}

}  // namespace

int main(int argc, char** argv) {
  const char* in_path = nullptr;
  const char* out_path = "-";
  std::string backend = "file";
  int bits = 16;
  int shift = 0;
  long amplitude = 2047;
  long buf_samples = 32768;
  SdrConfig rf;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> const char* {
      if (i + 1 >= argc) {
        usage();
        exit(1);
      }
      return argv[++i];
    };
    if (a == "-f") in_path = next();
    else if (a == "-b") bits = atoi(next());
    else if (a == "-s") shift = atoi(next());
    else if (a == "-a") amplitude = atol(next());
    else if (a == "-n") buf_samples = atol(next());
    else if (a == "-B") backend = next();
    else if (a == "-o") out_path = next();
    else if (a == "-F") rf.frequency_hz = atof(next());
    else if (a == "-r") rf.sample_rate_hz = atof(next());
    else if (a == "-g") rf.tx_gain = atoi(next());
    else if (a == "-c") rf.channel = atoi(next());
    else if (a == "-G") rf.gain_norm = sdr_lime_clamp_gain(atof(next()));
    else if (a == "-A") rf.atten_db = sdr_pluto_clamp_atten(atof(next()));
    else if (a == "-w") rf.bandwidth_hz = sdr_pluto_clamp_bw(atof(next()) * 1e6);
    else if (a == "-N") rf.pluto_addr = next();
    else { usage(); return 1; }
  }
  // 1-bit expansion amplitude follows limeplayer's dynamic clamp
  // (limeplayer.c:138-140).
  amplitude = sdr_lime_clamp_dynamic(amplitude);
  // Byte-oriented backends (hackrf) need the pipeline's value domain to
  // recover the 8-bit wire scale (sdr_backends.h).
  rf.input_bits = bits;
  rf.rescale_shift = shift;

  const SdrBackend* sdr = sdr_backend(backend.c_str());
  if (in_path == nullptr || (bits != 1 && bits != 8 && bits != 16) ||
      buf_samples <= 0 ||
      (backend != "file" && backend != "null" && sdr == nullptr)) {
    usage();
    return 1;
  }

  FILE* in = (strcmp(in_path, "-") == 0) ? stdin : fopen(in_path, "rb");
  if (in == nullptr) {
    fprintf(stderr, "ERROR: failed to open input file.\n");
    return 1;
  }

  FileSink sink{nullptr};
  FILE* out = nullptr;
  void* sdr_state = nullptr;
  pf_sink_fn sink_fn = write_sink;
  void* sink_user = &sink;
  if (backend == "file") {
    out = (strcmp(out_path, "-") == 0) ? stdout : fopen(out_path, "wb");
    if (out == nullptr) {
      fprintf(stderr, "ERROR: failed to open output file.\n");
      return 1;
    }
    sink.fp = out;
  } else if (sdr != nullptr && backend != "null") {
    const char* error = nullptr;
    sdr_state = sdr->open(rf, &error);
    if (sdr_state == nullptr) {
      fprintf(stderr, "ERROR: %s.\n", error);
      return 1;
    }
    sink_fn = sdr->send;
    sink_user = sdr_state;
  }

  int rc = pf_stream(in, bits, shift, static_cast<int16_t>(amplitude),
                     static_cast<size_t>(buf_samples), sink_fn, sink_user);
  if (sdr_state != nullptr) sdr->close(sdr_state);

  if (in != stdin) fclose(in);
  if (out != nullptr && out != stdout) fclose(out);
  if (rc != 0) {
    fprintf(stderr, "ERROR: streaming failed (%d).\n", rc);
    return 1;
  }
  fprintf(stderr, "Done! %zu samples streamed.\n", sink.values_written / 2);
  return 0;
}
