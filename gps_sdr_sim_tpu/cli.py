"""Command-line interface, flag-compatible with the reference simulator.

Parity target: the getopt loop and stderr UX of gpssim.c:1650-1852 and
:2037-2366 — same flags, same defaults, same error messages, same channel
table, plus extensions prefixed with `--` (batching, kernel
implementation, sharding).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gps_sdr_sim_tpu.constants import STATIC_MAX_DURATION, USER_MOTION_SIZE, R2D
from gps_sdr_sim_tpu.models.scenario import (
    ScenarioConfig,
    ScenarioError,
    build_scenario,
)
from gps_sdr_sim_tpu.utils.coord import llh2xyz
from gps_sdr_sim_tpu.utils.cstd import c_atof, c_atoi, c_sscanf_doubles
from gps_sdr_sim_tpu.utils.gpstime import DateTime


def _sscanf3(s: str):
    """sscanf(s, "%lf,%lf,%lf") — stop at the first failed conversion,
    leaving later fields at zero (the reference's variables are stack
    values; zero is the deterministic stand-in, gpssim.c:1774,1780)."""
    vals = c_sscanf_doubles(s, 3)
    return vals + [0.0] * (3 - len(vals))


def _err(msg: str):
    print(f"ERROR: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _usage():
    print(
        "Usage: gps-sdr-sim-tpu [options]\n"
        "Options:\n"
        "  -e <gps_nav>     RINEX navigation file for GPS ephemerides (required)\n"
        "  -u <user_motion> User motion file (dynamic mode)\n"
        "  -g <nmea_gga>    NMEA GGA stream (dynamic mode)\n"
        "  -c <location>    ECEF X,Y,Z in meters (static mode) e.g. 3967283.154,1022538.181,4872414.484\n"
        "  -l <location>    Lat,Lon,Hgt (static mode) e.g. 35.681298,139.766247,10.0\n"
        "  -t <date,time>   Scenario start time YYYY/MM/DD,hh:mm:ss\n"
        "  -T <date,time>   Overwrite TOC and TOE to scenario start time\n"
        f"  -d <duration>    Duration [sec] (dynamic mode max: {USER_MOTION_SIZE / 10.0:.0f}, "
        f"static mode max: {STATIC_MAX_DURATION})\n"
        "  -o <output>      I/Q sampling data file (default: gpssim.bin)\n"
        "  -s <frequency>   Sampling frequency [Hz] (default: 2600000)\n"
        "  -b <iq_bits>     I/Q data format [1/8/16] (default: 16)\n"
        "  -i               Disable ionospheric delay for spacecraft scenario\n"
        "  -v               Show details about simulated channels\n"
        "Extensions:\n"
        "  --impl <name>       Kernel: xla (default) or xla-sharded\n"
        "                      (all local devices)\n"
        "  --carrier-phase <m> Carrier NCO: float (default) or fixed\n"
        "                      (the reference's FLOAT_CARR_PHASE=0 build)\n"
        "  --batch-epochs <n>  Epochs per device dispatch (default: 20)\n"
        "  --motion-size <n>   Max user-motion points (default: 3000)\n"
        "  --shard-dir <dir>   Write time-shard files + manifest to <dir>\n"
        "                      instead of a single -o file\n"
        "  --shards <n>        Number of time shards (default: one per host)\n"
        "  --resume            Skip shards already complete in --shard-dir\n"
        "  --concat            After sharding, assemble -o from the shards\n"
        "  --multihost <spec>  coord_addr:port,process_id,num_processes —\n"
        "                      join a multi-host run\n"
        "  --profile <dir>     Write a jax.profiler trace of the run\n",
        file=sys.stderr)


_VALUE_FLAGS = ("-e", "-u", "-g", "-c", "-l", "-t", "-T", "-d", "-o", "-s",
                "-b")


def _merge_values(argv):
    """Join each value flag with its operand (getopt compatibility).

    argparse would otherwise reject negative operands like
    `-c -2694685.473,-4293642.366,3857878.924` or `-l -33.87,151.21,10`
    as unknown options; the C reference's getopt accepts them. A value
    flag with no operand left mirrors getopt's missing-argument path
    (message to stderr, then usage + exit 1, gpssim.c:1845-1848).
    """
    out, i = [], 0
    while i < len(argv):
        if argv[i] in _VALUE_FLAGS:
            if i + 1 >= len(argv):
                print(f"option requires an argument -- '{argv[i][1]}'",
                      file=sys.stderr)
                _usage()
                raise SystemExit(1)
            out.append(argv[i] + "=" + argv[i + 1])
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return out


# Per-occurrence validation, matching the reference's getopt loop: each
# -s/-b/-t/-T occurrence is validated AT ITS ARGV POSITION
# (gpssim.c:1788-1833), so `-s 999 -s 2600000` errors on the first -s and
# `-t garbage -d 90000` reports the date error, not the duration error
# (duration is only checked after the loop, gpssim.c:1869-1874).
class _SampFreqAction(argparse.Action):
    def __call__(self, parser, ns, value, option_string=None):
        if value < 1.0e6:
            _err("Invalid sampling frequency.")
        setattr(ns, self.dest, value)


class _BitsAction(argparse.Action):
    def __call__(self, parser, ns, value, option_string=None):
        if value not in (1, 8, 16):
            _err("Invalid I/Q data format.")
        setattr(ns, self.dest, value)


class _DateTimeAction(argparse.Action):
    def __call__(self, parser, ns, value, option_string=None):
        if not (option_string == "-T" and value.startswith("now")):
            _parse_datetime(value)  # errors like the reference's 't' case
        setattr(ns, self.dest, value)


def parse_args(argv) -> tuple:
    from gps_sdr_sim_tpu.runner import IMPLS

    argv = _merge_values(list(argv))
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("-e", dest="navfile", default="")
    ap.add_argument("-u", dest="umfile", default="")
    ap.add_argument("-g", dest="ggafile", default="")
    ap.add_argument("-c", dest="xyz", default="")
    ap.add_argument("-l", dest="llh", default="")
    ap.add_argument("-t", dest="t0", default="", action=_DateTimeAction)
    ap.add_argument("-T", dest="t0_overwrite", default="",
                    action=_DateTimeAction)
    # -d/-s use C atof semantics (unparsable -> 0.0, gpssim.c:1789,1838)
    # and -b C atoi, so malformed operands flow into the same validation
    # messages as the reference instead of an argparse type error.
    ap.add_argument("-d", dest="duration", type=c_atof, default=None)
    ap.add_argument("-o", dest="outfile", default="gpssim.bin")
    ap.add_argument("-s", dest="samp_freq", type=c_atof, default=2.6e6,
                    action=_SampFreqAction)
    ap.add_argument("-b", dest="bits", type=c_atoi, default=16,
                    action=_BitsAction)
    ap.add_argument("-i", dest="disable_iono", action="store_true")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("--impl", default="xla", choices=IMPLS)
    ap.add_argument("--carrier-phase", default="float",
                    choices=("float", "fixed"),
                    help="carrier NCO: float (reference default) or the "
                         "32-bit fixed-point variant (FLOAT_CARR_PHASE "
                         "undefined)")
    ap.add_argument("--batch-epochs", type=int, default=20)
    ap.add_argument("--motion-size", type=int, default=USER_MOTION_SIZE)
    ap.add_argument("--shard-dir", default="")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--concat", action="store_true")
    ap.add_argument("--json-summary", default="",
                    help="write a structured run summary to this path")
    ap.add_argument("--multihost", default="", metavar="COORD:PORT,ID,N",
                    help="join a multi-host run: coordinator address, this "
                         "process's index, total process count "
                         "(jax.distributed)")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="write a jax.profiler trace of the run to DIR")
    try:
        ns, extras = ap.parse_known_args(argv)
    except SystemExit:
        _usage()
        raise
    # getopt parity: unknown options print the missing-option message and
    # the usage (gpssim.c:1845-1848); bare non-option operands are ignored
    # (the reference's getopt permutes them past the loop, which never
    # reads argv[optind..]); a bare `--` ends option scanning, so
    # everything after it — even option-looking tokens — is an operand.
    for a in extras:
        if a == "--":
            break
        if a.startswith("-") and len(a) > 1:
            print(f"invalid option -- '{a.lstrip('-')[0]}'", file=sys.stderr)
            _usage()
            raise SystemExit(1)
    return ns


def _parse_datetime(s: str) -> DateTime:
    t = DateTime()
    try:
        date, clock = s.split(",")
        y, m, d = date.split("/")
        hh, mm, sec = clock.split(":")
        t.y, t.m, t.d = int(y), int(m), int(d)
        t.hh, t.mm, t.sec = int(hh), int(mm), float(sec)
    except ValueError:
        _err("Invalid date and time.")
    if (t.y <= 1980 or not 1 <= t.m <= 12 or not 1 <= t.d <= 31
            or not 0 <= t.hh <= 23 or not 0 <= t.mm <= 59
            or not 0.0 <= t.sec < 60.0):
        _err("Invalid date and time.")
    t.sec = float(int(t.sec))  # C: floor(t0.sec) (gpssim.c:1833)
    return t


def _write_json_summary(path: str, stats, samp_freq: float,
                        phases: dict | None = None) -> None:
    import json

    d = stats.summary(samp_freq)
    if phases:
        # Wall-clock attribution of everything OUTSIDE the synthesis loop
        # (process spawn/import can be derived by the caller from
        # main_start_unix vs its own launch timestamp). SCALING_r04 weak
        # #5: the multihost startup bucket was one opaque number.
        d["phases"] = {k: round(v, 3) for k, v in phases.items()}
    with open(path, "w") as jfp:
        json.dump(d, jfp, indent=1)


def build_config(ns) -> ScenarioConfig:
    # -s/-b/-t/-T were already validated per occurrence at parse time
    # (argv order, see the _*Action classes); only the post-loop checks of
    # gpssim.c:1856-1874 remain here, in the reference's order.
    if not ns.navfile:
        _err("GPS ephemeris file is not specified.")

    static_xyz = None
    if ns.xyz:
        static_xyz = np.array(_sscanf3(ns.xyz))
    elif ns.llh:
        lat, lon, hgt = _sscanf3(ns.llh)
        static_xyz = llh2xyz(np.array([lat / R2D, lon / R2D, hgt]))

    # Duration validation mirrors gpssim.c:1869-1874 and must precede the
    # "Using static location mode." print (the reference validates at
    # :1869, prints at :1914).
    static_mode = static_xyz is not None or not (ns.umfile or ns.ggafile)
    duration = (ns.duration if ns.duration is not None
                else ns.motion_size / 10.0)
    max_dur = (STATIC_MAX_DURATION if static_mode
               else ns.motion_size / 10.0)
    if duration < 0.0 or duration > max_dur:
        _err("Invalid duration.")

    t0 = None
    timeoverwrite = False
    if ns.t0_overwrite:
        timeoverwrite = True
        if ns.t0_overwrite.startswith("now"):
            gmt = time.gmtime()
            t0 = DateTime(gmt.tm_year, gmt.tm_mon, gmt.tm_mday, gmt.tm_hour,
                          gmt.tm_min, float(gmt.tm_sec))
        else:
            t0 = _parse_datetime(ns.t0_overwrite)
    elif ns.t0:
        t0 = _parse_datetime(ns.t0)

    return ScenarioConfig(
        nav_file=ns.navfile,
        out_file=ns.outfile,
        samp_freq=ns.samp_freq,
        data_format=ns.bits,
        static_xyz=static_xyz,
        motion_file=ns.umfile or None,
        nmea_file=ns.ggafile or None,
        duration=ns.duration,
        t0=t0,
        timeoverwrite=timeoverwrite,
        iono_enable=not ns.disable_iono,
        verbose=ns.verbose,
        max_motion_points=ns.motion_size,
        carrier_phase_mode=ns.carrier_phase,
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        _usage()
        return 1
    ns = parse_args(argv)
    phases = {"main_start_unix": time.time()}

    if ns.multihost:
        # Must run before ANY jax call that initializes the XLA backend.
        # Each process then writes its own disjoint time-shards.
        import jax

        t_ph = time.time()
        try:
            coord, pid, nproc = ns.multihost.rsplit(",", 2)
            jax.distributed.initialize(coordinator_address=coord,
                                       num_processes=int(nproc),
                                       process_id=int(pid))
        except (ValueError, RuntimeError) as e:
            _err(f"Invalid --multihost spec or coordination failure: {e}")
        phases["dist_init_s"] = time.time() - t_ph
        if not ns.shard_dir:
            _err("--multihost requires --shard-dir (per-host shard files).")
    cfg = build_config(ns)

    if cfg.static_xyz is not None or (not cfg.motion_file
                                      and not cfg.nmea_file):
        print("Using static location mode.", file=sys.stderr)

    t_ph = time.time()
    try:
        scn = build_scenario(cfg)
    except ScenarioError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    phases["build_scenario_s"] = time.time() - t_ph

    if cfg.verbose and scn.ionoutc_file.vflg:
        # The reference dumps the file's values BEFORE any -T overwrite.
        io = scn.ionoutc_file
        print(f"  {io.alpha0:12.3e} {io.alpha1:12.3e} {io.alpha2:12.3e} "
              f"{io.alpha3:12.3e}", file=sys.stderr)
        print(f"  {io.beta0:12.3e} {io.beta1:12.3e} {io.beta2:12.3e} "
              f"{io.beta3:12.3e}", file=sys.stderr)
        print(f"   {io.A0:19.11e} {io.A1:19.11e}  {io.tot:9d} {io.wnt:9d}",
              file=sys.stderr)
        print(f"{io.dtls:6d}", file=sys.stderr)

    t0, g0 = scn.t0, scn.g0
    print(f"Start time = {t0.y:4d}/{t0.m:02d}/{t0.d:02d},"
          f"{t0.hh:02d}:{t0.mm:02d}:{t0.sec:02.0f} ({g0.week}:{g0.sec:.0f})",
          file=sys.stderr)
    print(f"Duration = {scn.numd / 10.0:.1f} [sec]", file=sys.stderr)

    # The reference opens the output file (gpssim.c:2100-2111) BEFORE the
    # channel table print (:2131-2136); mirror the order so the failure
    # path's stderr matches byte-for-byte.
    fp = None
    close_fp = False
    if not ns.shard_dir:
        if cfg.out_file == "-":
            fp = sys.stdout.buffer
        else:
            try:
                fp = open(cfg.out_file, "wb")
                close_fp = True
            except OSError:
                print("ERROR: Failed to open output file.", file=sys.stderr)
                return 1

    # Initial channel table (gpssim.c:2131-2136); verbose tables follow.
    tables = scn.channel_tables if cfg.verbose else scn.channel_tables[:1]
    for _iumd, rows in tables:
        for prn, az, el, d, iono in rows:
            print(f"{prn:02d} {az:6.1f} {el:5.1f} {d:11.1f} {iono:5.1f}",
                  file=sys.stderr)

    from gps_sdr_sim_tpu.utils.compcache import enable as enable_cache
    enable_cache()

    profiler = None
    if ns.profile:
        import jax

        jax.profiler.start_trace(ns.profile)
        profiler = ns.profile

    try:
        return _run(ns, cfg, scn, fp, close_fp, phases)
    finally:
        if profiler is not None:
            import jax

            jax.profiler.stop_trace()
            print(f"profiler trace written to {profiler}", file=sys.stderr)


def _run(ns, cfg, scn, fp, close_fp, phases=None) -> int:
    from gps_sdr_sim_tpu.runner import run_simulation

    phases = phases if phases is not None else {}
    if ns.shard_dir:
        from gps_sdr_sim_tpu.parallel.writer import (
            concat_shards,
            run_simulation_sharded,
        )

        t_start = time.time()
        try:
            _manifest, stats = run_simulation_sharded(
                scn, ns.shard_dir, n_shards=ns.shards,
                batch_epochs=ns.batch_epochs, impl=ns.impl,
                resume=ns.resume)
        except ValueError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        if ns.concat:
            import jax

            t_ph = time.time()
            if jax.process_count() > 1:
                # Wait for every host's shards, then let exactly one
                # process assemble the file.
                from jax.experimental import multihost_utils

                multihost_utils.sync_global_devices("shards_complete")
            phases["shard_sync_s"] = time.time() - t_ph
            t_ph = time.time()
            if jax.process_index() == 0:
                concat_shards(ns.shard_dir, cfg.out_file)
            phases["concat_s"] = time.time() - t_ph
        if ns.json_summary:
            _write_json_summary(ns.json_summary, stats, scn.samp_freq,
                                phases)
        print("\nDone!", file=sys.stderr)
        print(f"Process time = {time.time() - t_start:.1f} [sec]",
              file=sys.stderr)
        return 0

    t_start = time.time()
    try:
        stats = run_simulation(scn, fp, batch_epochs=ns.batch_epochs,
                               impl=ns.impl)
    finally:
        if close_fp:
            fp.close()

    print("\nDone!", file=sys.stderr)
    print(f"Process time = {time.time() - t_start:.1f} [sec]", file=sys.stderr)
    if stats.wall_seconds:
        rt = stats.samples_per_second / scn.samp_freq
        print(f"Throughput = {stats.samples_per_second / 1e6:.1f} Msamples/s "
              f"({rt:.1f}x real time)", file=sys.stderr)
    if ns.json_summary:
        _write_json_summary(ns.json_summary, stats, scn.samp_freq, phases)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
