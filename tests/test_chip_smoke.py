"""chip_smoke.py and bench.py: they refuse anything but a GPU, and the smoke
phases run end to end at tiny sizes on the CPU (the same functions the GPU
run calls at full width)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(cmd, cwd=REPO, timeout=300, env=None):
    env = dict(os.environ if env is None else env, JAX_PLATFORMS="cpu")
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _no_result(stdout: str) -> bool:
    """No final {"ok": true, ...} line and no rate anywhere."""
    lines = [l for l in stdout.splitlines() if l.strip()]
    return not any('"ok": true' in l and '"device"' in l for l in lines) and \
        "steps_per" not in stdout


def test_chip_smoke_refuses_a_machine_without_gpu():
    r = _run([sys.executable, "chip_smoke.py"])
    assert r.returncode != 0
    assert _no_result(r.stdout)
    assert '"phase": "device", "ok": false' in r.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert _no_result(r.stdout)


@pytest.mark.parametrize("args", [[], ["--user-scene"], ["--sharded"]],
                         ids=["dense", "user_scene", "sharded"])
def test_bench_refuses_a_machine_without_gpu(args):
    r = _run([sys.executable, "bench.py", "--particles", "4096", "--frames", "1",
              *args])
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs a GPU" in r.stderr


def test_smoke_child_phases_refuse_the_cpu():
    r = _run([sys.executable, "chip_smoke.py", "--phase", "dense"])
    assert r.returncode != 0
    assert "not 'gpu'" in r.stderr


def test_phase_device_reports_the_cpu_when_allowed():
    out = chip_smoke.phase_device(require_gpu=False)
    assert out["platform"] == "cpu" and out["count"] >= 1
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.phase_device()


def test_phase_dense_tiny():
    out = chip_smoke.phase_dense(slots=(4096,), frames=2, steps=18)
    assert set(out) == {"dense_4096"}
    row = out["dense_4096"]
    assert row["grid"] == [32, 16, 8]
    assert row["sim_steps_per_s"] > 0 and row["live_end"] <= row["live"]
    assert row["memory"]["argument"] > 0
    assert row["compile_cold_s"] > 0 and row["compile_warm_s"] > 0
    # XLA-CPU stores the 3x3 stack: the check must see it
    assert row["stack9_materialised"] and row["stack9_buffers"] >= 1
    assert row["step_ms"] > 0 and row["move_ms"] > 0


def test_phase_allpairs_tiny():
    out = chip_smoke.phase_allpairs(sides=(6, 8), frames=2)
    assert out["droplet"]["particles"] == 36 and out["gas"]["particles"] == 64
    for r in out.values():
        assert r["kernel"] == "allpairs-cpu"
        assert r["capacity"] == 1024 and r["pairs_per_s"] > 0


def test_phase_numerics_tiny():
    out = chip_smoke.phase_numerics(
        droplet_side=8, gas_side=12, dense_slots=4096,
        samples={"allpairs_2k": None, "allpairs_16k": 60, "bucket_1m": 300})
    for key in ("allpairs_2k", "allpairs_16k", "bucket_1m", "dense_readback_1m"):
        assert out[key]["ok"], out[key]
    assert out["allpairs_16k"]["compared"] == 60


def test_phase_editor_tiny(tmp_path):
    out = chip_smoke.phase_editor(tmp_path, 240, lattice=(8, 8), frames=4,
                                  expect_kernel="bucket-cpu")
    assert out["live_counts"] == [64] * 4
    assert out["kernel"] == "bucket-cpu"
    assert out["first_frame_s"] > 0 and out["frames_per_s"] > 0


def test_phase_sharded_tiny(tmp_path):
    """The --devices path on 4 virtual CPU devices: one-device daemon vs the
    2x2-mesh daemon, frame by frame."""
    out, device = chip_smoke.phase_sharded(tmp_path, 480, 4, lattice=(10, 10),
                                           frames=3, platform="cpu")
    assert device["count"] >= 4
    assert out["sharded"]["kernel"] == "sharded-cpu"
    assert out["one_device"]["kernel"] == "bucket-cpu"
    assert out["comparison"]["ok"] and out["comparison"]["frames"] == 3


def test_compare_streams_flags_differences():
    from particle_simulator_tpu.io.frame import Frame
    from particle_simulator_tpu.physics.crosscheck import Tolerance

    a = Frame.new()
    a.push(a.metadata.new_particle((1e-9, 1e-9), (10.0, 0.0)))
    b = Frame.from_particles(a.metadata.copy(), a.particles.copy())
    tol = Tolerance(8, 1e-4, 1e-6)
    assert chip_smoke.compare_streams([a], [b], tol)["ok"]
    b.particles["x"] += np.uint32(9)
    assert not chip_smoke.compare_streams([a], [b], tol)["ok"]
    assert not chip_smoke.compare_streams([a, a], [b], tol)["ok"]


def test_entry_buffers_counts_only_the_entry_computation():
    hlo = (
        "%fused (p: f32[4,4,72]) -> f32[4,4] {\n"
        "  %c = f32[4,4,72]{2,1,0} concatenate(...)\n}\n"
        "ENTRY %main (a: u32[4,4,8]) -> f32[4,4] {\n"
        "  %f = f32[4,4,72]{2,1,0} fusion(%a), kind=kLoop\n"
        "  %g = u32[4,4,72]{2,1,0} fusion(%a), kind=kLoop\n"
        "  ROOT %r = f32[4,4]{1,0} fusion(%f, %g), kind=kInput\n}\n"
    )
    assert chip_smoke._entry_buffers(hlo, (4, 4, 72)) == 2
    assert chip_smoke._entry_buffers(hlo, (4, 4, 9)) == 0


def test_result_line_is_exactly_the_contract():
    dev = chip_smoke.phase_device(require_gpu=False)
    parsed = json.loads(chip_smoke.result_line(dev))
    assert parsed == {"ok": True, "device": {
        "platform": "cpu", "kind": dev["kind"], "count": dev["count"]}}
