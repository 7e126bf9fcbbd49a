"""Unit tests for host->device batch planning (ops/plan.py)."""

import numpy as np

from gps_sdr_sim_tpu.constants import CA_SEQ_LEN, CODE_FREQ, MAX_CHAN
from gps_sdr_sim_tpu.models.scenario import Segment
from gps_sdr_sim_tpu.ops.plan import pad_epoch_axis, plan_batch


def _segment(E: int, fixed: bool = False) -> Segment:
    rng = np.random.default_rng(0)
    C = MAX_CHAN
    f_carr = rng.uniform(-5000, 5000, (E, C))
    return Segment(
        first_epoch=1, n_epochs=E,
        active=np.ones(C, bool), prn=np.arange(1, C + 1, dtype=np.int32),
        ca=rng.choice(np.array([-1, 1], np.int8), size=(C, CA_SEQ_LEN)),
        bits=rng.choice(np.array([-1, 1], np.int8), size=(C, 1800)),
        f_carr=f_carr, f_code=CODE_FREQ + f_carr / 1540.0,
        code_phase0=rng.uniform(0, CA_SEQ_LEN, (E, C)),
        carr_phase0=(rng.integers(0, 1 << 25, (E, C)) / (1 << 25) if fixed
                     else rng.uniform(0, 1, (E, C))),
        m0=rng.integers(0, 1500 * 20, (E, C)).astype(np.int32),
        gain=rng.integers(50, 200, (E, C)).astype(np.int32),
        carr_fixed=fixed,
    )


def test_pad_epoch_axis_leaves_ca_words_alone():
    """ca_words is [C, 32]: when the epoch count equals MAX_CHAN it must
    NOT be treated as epoch-axis data (regression: shape-keyed padding
    edge-padded it to [target_b, 32], which silently breaks channel
    sharding and forces fresh kernel retraces)."""
    E = MAX_CHAN  # the collision case
    seg = _segment(E)
    db = plan_batch(seg, 0, E, 4096, 1.0 / 1.0e6)
    assert db.ca_words.shape == (MAX_CHAN, 32)
    padded = pad_epoch_axis(db, E + 8)
    assert padded.ca_words.shape == (MAX_CHAN, 32)
    np.testing.assert_array_equal(padded.ca_words, db.ca_words)
    assert padded.gain.shape[0] == E + 8
    assert np.all(padded.gain[E:] == 0)


def test_streaming_scenario_matches_materialized():
    """build_scenario_streaming must yield the exact segments (and channel
    tables) of the materialized build — the lazy day-scale planner is the
    same engine, just pulled on demand."""
    import dataclasses

    from gps_sdr_sim_tpu.constants import R2D
    from gps_sdr_sim_tpu.models.scenario import (
        ScenarioConfig, build_scenario, build_scenario_streaming)
    from gps_sdr_sim_tpu.utils.coord import llh2xyz

    cfg = ScenarioConfig(
        nav_file="data/brdc3540.14n", duration=65.0, samp_freq=1.0e6,
        verbose=True,
        static_xyz=llh2xyz(np.array([35.681298 / R2D, 139.766247 / R2D,
                                     10.0])))
    want = build_scenario(cfg)
    scn, engine = build_scenario_streaming(cfg)
    assert scn.segments == []
    got = list(engine.iter_run())

    assert len(got) == len(want.segments) > 1  # crosses 30 s boundaries
    for a, b in zip(got, want.segments):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name
    assert engine.tables == want.channel_tables
    assert scn.channel_tables is engine.tables  # alias survives iteration
