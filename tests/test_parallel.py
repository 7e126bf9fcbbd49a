"""Sharding correctness on a virtual 8-device CPU mesh (see conftest.py).

Invariants (SURVEY.md §4): N-device shard_map output is bit-identical to
the 1-device kernel for every (time, chan) mesh factorization; time-shard
files concatenate to the exact single-file byte stream regardless of where
block boundaries fall; resume regenerates exactly the missing shards.
"""

import io
import pathlib

import numpy as np
import pytest

from gps_sdr_sim_tpu.constants import R2D
from gps_sdr_sim_tpu.models.scenario import ScenarioConfig, build_scenario
from gps_sdr_sim_tpu.ops.plan import plan_batch
from gps_sdr_sim_tpu.ops.synth_jnp import synth_batch
from gps_sdr_sim_tpu.parallel import (
    auto_mesh,
    concat_shards,
    plan_epoch_shards,
    run_simulation_sharded,
    synth_batch_sharded,
)
from gps_sdr_sim_tpu.parallel.writer import bytes_per_epoch
from gps_sdr_sim_tpu.runner import run_simulation
from gps_sdr_sim_tpu.utils.coord import llh2xyz

DATA = pathlib.Path(__file__).parent.parent / "data"
TOKYO = llh2xyz(np.array([35.681298 / R2D, 139.766247 / R2D, 10.0]))


# 200 ksps keeps XLA:CPU compile + run times small; sharding correctness is
# rate-independent (the kernels' fixed-point plans handle code steps above
# one chip/sample, see ops/plan.py), and cross-implementation equality is
# the invariant here -- the C-oracle comparisons live in test_iq_golden.py.
SAMP = 2.0e5


@pytest.fixture(scope="module")
def scenario():
    cfg = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                         static_xyz=TOKYO, duration=0.8, samp_freq=SAMP)
    return build_scenario(cfg)


@pytest.fixture(scope="module")
def batch(scenario):
    seg = scenario.segments[0]
    return plan_batch(seg, 0, seg.n_epochs, scenario.iq_buff_size,
                      scenario.delt)


@pytest.mark.parametrize("n_time,n_chan", [(8, 1), (1, 8), (4, 2), (2, 4)])
def test_mesh_invariance(scenario, batch, n_time, n_chan):
    """Any mesh factorization reproduces the 1-device output bit-exactly."""
    ref = np.asarray(synth_batch(batch, scenario.iq_buff_size))
    mesh = auto_mesh(n_time * n_chan, n_chan)
    out = np.asarray(synth_batch_sharded(batch, scenario.iq_buff_size, mesh))
    np.testing.assert_array_equal(out, ref)


def test_time_padding_sharded(scenario, batch):
    """B=7 epochs on an 8-wide time axis: padding is silent and stripped."""
    mesh = auto_mesh(8, 1)
    ref = np.asarray(synth_batch(batch, scenario.iq_buff_size))
    out = np.asarray(synth_batch_sharded(batch, scenario.iq_buff_size, mesh))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_plan_epoch_shards():
    ranges = plan_epoch_shards(10, 3)
    assert ranges == [(0, 4), (4, 7), (7, 10)]
    assert plan_epoch_shards(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


@pytest.mark.parametrize("data_format", [16, 1])
def test_shard_files_concat_bitexact(tmp_path, data_format):
    """Time-shard files assemble to the exact single-process byte stream."""
    cfg = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                         static_xyz=TOKYO, duration=0.7, samp_freq=SAMP,
                         data_format=data_format)
    scn = build_scenario(cfg)
    buf = io.BytesIO()
    run_simulation(scn, buf, batch_epochs=2, log=lambda s: None, impl="xla")

    out_dir = tmp_path / f"shards{data_format}"
    run_simulation_sharded(scn, str(out_dir), n_shards=3, batch_epochs=2,
                           impl="xla")
    out_file = tmp_path / f"joined{data_format}.bin"
    manifest = concat_shards(str(out_dir), str(out_file))
    assert manifest.total_epochs == scn.n_output_epochs
    assert out_file.read_bytes() == buf.getvalue()


def test_shard_resume_regenerates_missing(tmp_path):
    """Deleting one shard + resume=True restores the byte-exact stream."""
    cfg = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                         static_xyz=TOKYO, duration=0.5, samp_freq=SAMP)
    scn = build_scenario(cfg)
    out_dir = tmp_path / "shards"
    run_simulation_sharded(scn, str(out_dir), n_shards=2, batch_epochs=2,
                           impl="xla")
    victim = out_dir / "shard_00001.bin"
    good = victim.read_bytes()
    victim.write_bytes(good[: len(good) // 2])  # simulate a failed host

    mtime0 = (out_dir / "shard_00000.bin").stat().st_mtime_ns
    run_simulation_sharded(scn, str(out_dir), n_shards=2, batch_epochs=2,
                           impl="xla", resume=True)
    assert victim.read_bytes() == good
    # The intact shard was not rewritten.
    assert (out_dir / "shard_00000.bin").stat().st_mtime_ns == mtime0


def test_epoch_range_split_anywhere_bitexact(scenario):
    """[0,N) in one go == [0,k) + [k,N) for any split and batch size."""
    from gps_sdr_sim_tpu.runner import run_epoch_range

    n = scenario.n_output_epochs
    whole = io.BytesIO()
    run_simulation(scenario, whole, batch_epochs=20, log=lambda s: None,
                   impl="xla")
    for k, be in ((1, 3), (n // 2, 7), (n - 1, 20)):
        parts = io.BytesIO()
        run_epoch_range(scenario, parts, 0, k, batch_epochs=be,
                        log=lambda s: None, impl="xla")
        run_epoch_range(scenario, parts, k, n, batch_epochs=be,
                        log=lambda s: None, impl="xla")
        assert parts.getvalue() == whole.getvalue(), (k, be)


@pytest.mark.parametrize("impl", ["xla-sharded"])
def test_runner_sharded_impls_match_single(scenario, impl):
    """run_simulation over the full local (virtual) mesh == single device."""
    ref = io.BytesIO()
    run_simulation(scenario, ref, batch_epochs=2, log=lambda s: None,
                   impl="xla")
    got = io.BytesIO()
    run_simulation(scenario, got, batch_epochs=2, log=lambda s: None,
                   impl=impl)
    assert got.getvalue() == ref.getvalue()


def test_shard_resume_refuses_different_scenario(tmp_path):
    """A stale shard dir from different inputs must be refused on resume,
    even when bytes-per-epoch happen to match (manifest scenario hash)."""
    cfg_a = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                           static_xyz=TOKYO, duration=0.4, samp_freq=SAMP)
    out_dir = tmp_path / "shards"
    run_simulation_sharded(build_scenario(cfg_a), str(out_dir), n_shards=2,
                           batch_epochs=2, impl="xla")

    other = llh2xyz(np.array([0.1, 0.2, 100.0]))
    cfg_b = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                           static_xyz=other, duration=0.4, samp_freq=SAMP)
    with pytest.raises(ValueError, match="different scenario"):
        run_simulation_sharded(build_scenario(cfg_b), str(out_dir),
                               n_shards=2, batch_epochs=2, impl="xla",
                               resume=True)
    # Same scenario resumes fine (no-op: all shards complete).
    run_simulation_sharded(build_scenario(cfg_a), str(out_dir), n_shards=2,
                           batch_epochs=2, impl="xla", resume=True)


def test_sharded_run_returns_aggregated_stats(tmp_path):
    """run_simulation_sharded aggregates RunStats (feeds --json-summary)."""
    cfg = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                         static_xyz=TOKYO, duration=0.4, samp_freq=SAMP)
    scn = build_scenario(cfg)
    _manifest, stats = run_simulation_sharded(
        scn, str(tmp_path / "s"), n_shards=2, batch_epochs=2, impl="xla")
    assert stats.total_samples == scn.total_samples
    assert stats.device_batches >= 2
    assert stats.wall_seconds > 0


@pytest.mark.parametrize("data_format", [16, 8, 1])
def test_xla_sharded_matches_single_per_format(data_format):
    """The runner's xla-sharded impl over all 8 (virtual) devices writes the
    single-device byte stream in every output format; 3 epochs on an
    8-wide time axis also exercise the silent time padding."""
    cfg = ScenarioConfig(nav_file=str(DATA / "brdc3540.14n"),
                         static_xyz=TOKYO, duration=0.4, samp_freq=SAMP,
                         data_format=data_format)
    scn = build_scenario(cfg)
    outs = []
    for impl in ("xla", "xla-sharded"):
        buf = io.BytesIO()
        run_simulation(scn, buf, batch_epochs=3, log=lambda s: None,
                       impl=impl)
        outs.append(buf.getvalue())
    assert len(outs[0]) == scn.n_output_epochs * bytes_per_epoch(
        scn.iq_buff_size, data_format)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("case", ["mesh_chan", "devices", "batch_chan"])
def test_channel_count_errors(batch, case):
    """Channel sharding refuses splits that do not divide the channels."""
    from gps_sdr_sim_tpu.parallel import make_mesh

    with pytest.raises(ValueError):
        if case == "mesh_chan":  # 3 does not divide MAX_CHAN=16
            make_mesh(2, 3)
        elif case == "devices":  # 8 devices do not split into chan=3
            auto_mesh(8, 3)
        else:  # a 6-channel batch on a 4-wide 'chan' axis
            import dataclasses

            cut = {f.name: getattr(batch, f.name) for f in
                   dataclasses.fields(batch)}
            for k in ("code_s", "carr_s", "m0", "b0", "navbits", "gain"):
                cut[k] = cut[k][:, :6]
            for k in ("code_p", "carr_p", "t_base"):
                cut[k] = cut[k][:, :, :6]
            cut["ca_words"] = cut["ca_words"][:6]
            synth_batch_sharded(type(batch)(**cut), 1000, auto_mesh(8, 4))


def test_runner_rejects_unknown_impl(scenario):
    with pytest.raises(ValueError, match="unknown impl"):
        run_simulation(scenario, io.BytesIO(), impl="pallas")
