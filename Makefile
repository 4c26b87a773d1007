# Top-level build/run entry points (the reference drives everything through
# cuda_simulator/Makefile + SLURM scripts; here the equivalents are make
# targets — there is no cluster scheduler dependency).

PY ?= python
CPU_ENV = JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

.PHONY: all native test test-gpu smoke bench daemon editor dryrun clean

all: native test

native:
	$(MAKE) -C native

test:
	$(PY) -m pytest tests/ -q

# card-only numerics (GPU host; skips elsewhere)
test-gpu:
	PS_TEST_PLATFORM=cuda,cpu $(PY) -m pytest -m gpu tests/test_gpu_hw.py -q

# every main path on one GPU, checked; last line {"ok": true, ...}
smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

# engine daemon (connects to the editor's TCP server)
daemon:
	$(PY) -m particle_simulator_tpu.engine.daemon --addr 127.0.0.1:53123

# headless editor session (TCP server; sends a lattice, collects frames)
editor:
	$(PY) -m particle_simulator_tpu.editor.headless --frames 20

# sharded jnp frame program on a virtual 8-device CPU mesh, checked against
# the single-device frame
dryrun:
	$(CPU_ENV) $(PY) -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun OK')"

clean:
	$(MAKE) -C native clean
	rm -rf .jax_cache .smoke_tmp
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
