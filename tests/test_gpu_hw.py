"""Card-only numerics: the GPU runners against the NumPy oracle at real widths.

Every test here is marked ``gpu`` and skips where JAX has no GPU (the
``gpu_device`` fixture decides at run time, so every xdist worker collects
the same tests). Run on a GPU host, one process on the card:

    PS_TEST_PLATFORM=cuda,cpu python -m pytest -m gpu tests/test_gpu_hw.py

The widths are chip_smoke.py's numerics phase: all-pairs at 2k (every row)
and 16k (1024 seeded rows), the bucket step on the 1M dense grid (4096
seeded rows), the dense-pack readback at 1M. Tolerances are
physics/crosscheck.py's (the CPU suite's).
"""

import pytest

from particle_simulator_tpu.physics import crosscheck
from particle_simulator_tpu.scenes.library import (
    dense_grid_config,
    dense_grid_scene,
    gas_diffusion,
    liquid_droplet,
)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("build,sample", [(liquid_droplet, None), (gas_diffusion, 1024)],
                         ids=["droplet_2k", "gas_16k"])
def test_allpairs_matches_oracle_on_gpu(gpu_device, build, sample):
    frame = build()
    result = crosscheck.allpairs_vs_oracle(frame.particles, frame.metadata.copy(),
                                           sample=sample, seed=1)
    assert result["ok"], result


def test_bucket_step_matches_oracle_on_gpu(gpu_device):
    state, meta, _ = dense_grid_scene(dense_grid_config(1 << 20, 8))
    result = crosscheck.bucket_step_vs_oracle(state, meta, sample=4096, seed=2)
    assert result["ok"], result


def test_dense_readback_bit_exact_on_gpu(gpu_device):
    state, _, _ = dense_grid_scene(dense_grid_config(1 << 20, 8))
    result = crosscheck.dense_readback_vs_host(state)
    assert result["ok"], result


def test_frame_runners_run_on_gpu(gpu_device):
    """The engine picks the GPU runners, and a frame of each stays finite
    and keeps its particles (sparse scenes drop nothing)."""
    import numpy as np

    from particle_simulator_tpu.engine.simulator import Simulator
    from particle_simulator_tpu.io.frame import DataStructure

    for ds, kernel in ((DataStructure.MATRIX_BUCKETS, "bucket-gpu"),
                       (DataStructure.COMPACT_ARRAY, "allpairs-gpu")):
        frame = gas_diffusion(64)
        frame.metadata.data_structure = ds
        sim = Simulator()
        sim.load_frame(frame)
        sim.frame_async()
        out = sim.read_frame()
        assert sim.active_kernel == kernel
        assert out.particle_count == frame.particle_count
        assert np.isfinite(out.particles["vx"]).all()
