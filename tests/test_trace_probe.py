"""scripts/trace_probe.py: the trace reduction behind PERF.md's device split."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))

import trace_probe  # noqa: E402


def _event(pid, name, ts, dur):
    return {"ph": "X", "pid": pid, "tid": 1, "name": name, "ts": ts, "dur": dur}


def test_reduce_trace_union_idle_share_and_top_ops():
    trace = {"traceEvents": [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 2, "name": "process_name", "args": {"name": "/device:GPU:0"}},
        _event(1, "python", 0, 10_000),           # host events are not device time
        _event(2, "fusion_a", 0, 1_000),
        _event(2, "fusion_b", 500, 1_000),        # overlaps fusion_a by 0.5 ms
        _event(2, "fusion_a", 3_000, 1_000),      # after a 1.5 ms gap
    ]}
    out = trace_probe.reduce_trace(trace, steps=2)
    assert set(out) == {"/device:GPU:0"}
    d = out["/device:GPU:0"]
    assert d["span_ms"] == pytest.approx(4.0)
    assert d["busy_ms"] == pytest.approx(2.5)
    assert d["idle_share"] == pytest.approx(1 - 2.5 / 4.0)
    assert d["busy_ms_per_step"] == pytest.approx(1.25)
    assert d["top_ms_per_step"] == [["fusion_a", 1.0], ["fusion_b", 0.5]]


def test_traced_writes_and_reads_a_trace(tmp_path):
    """On the CPU the trace has no /device: process, so the reduction is
    empty; the trace file is found and parsed all the same."""
    import jax

    from particle_simulator_tpu.engine.state import SimParams
    from particle_simulator_tpu.physics.bucket import run_frame_bucket
    from particle_simulator_tpu.scenes.library import dense_grid_config, dense_grid_scene

    state, meta, _ = dense_grid_scene(dense_grid_config(4096, 8))
    params = SimParams.from_record(meta)._replace(steps_per_frame=np.int32(3))
    out = trace_probe.traced("dense_4096", jax.jit(run_frame_bucket), state, params,
                             2, tmp_path)
    assert out["case"] == "dense_4096" and out["steps"] == 6
    assert out["devices"] == {} and out["wall_s"] > 0
