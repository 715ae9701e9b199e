# Dev workflow targets (analog of the reference's Makefile test/bench/profile)

PY ?= python

.PHONY: test test-tpu bench bench-full build-native clean-native roundtrip graph docs soak ubsan-native asan-native sanitize ubsan-torch asan-torch

test:
	$(PY) -m pytest tests/ -q

# on-chip Pallas kernel parity (needs real TPU; main suite runs forced-CPU)
test-tpu:
	NANORQ_TEST_TPU=1 $(PY) -m pytest tests/test_pallas_tpu.py -q

# headline benchmark (one JSON line on stdout; per-K detail on stderr)
bench:
	$(PY) bench.py --ks 1000 --iters 40

bench-full:
	$(PY) bench.py --full --iters 20

build-native:
	$(PY) -c "from nanorq_tpu.native import native_available; assert native_available(), 'native build failed'; print('native solver OK')"

clean-native:
	rm -rf nanorq_tpu/native/_build

# native runtime under sanitizers (reference Makefile:95-99 analog), two
# halves because LD_PRELOADed ASan aborts inside the XLA compiler:
#  - ubsan-native: UBSan linked into the .so, FULL native+residual pytest
#    suites (device paths included)
#  - asan-native: ASan+UBSan preloaded over a jax-free driver covering the
#    raw-pointer write-through paths (_row_ptrs/_out_row_ptrs)
ubsan-native:
	NANORQ_NATIVE_SANITIZE=undefined \
	$(PY) -m pytest tests/test_native.py tests/test_residual.py -q

asan-native:
	NANORQ_NATIVE_SANITIZE=address,undefined \
	LD_PRELOAD=$$(gcc -print-file-name=libasan.so) \
	ASAN_OPTIONS=detect_leaks=0 \
	$(PY) tools/asan_drive.py

sanitize: ubsan-native asan-native

# the PyTorch port's native copy (nanorq_tpu_torch/native) under the same
# sanitizers: UBSan over its native, residual and codec tests; ASan+UBSan
# preloaded over tools/asan_drive.py, which imports torch (torch survives the preload)
ubsan-torch:
	NANORQ_NATIVE_SANITIZE=undefined \
	$(PY) -m pytest tests/test_torch_host.py tests/test_torch_residual.py tests/test_torch_codec.py -q

asan-torch:
	NANORQ_NATIVE_SANITIZE=address,undefined \
	LD_PRELOAD=$$(gcc -print-file-name=libasan.so) \
	ASAN_OPTIONS=detect_leaks=0 \
	$(PY) -m nanorq_tpu_torch.tools.asan_drive

# end-to-end file round trip through the CLIs (reference `make test` analog)
roundtrip:
	$(PY) -m pytest tests/test_cli.py -q

# randomized end-to-end soak beyond the pytest grid (CPU; minutes as arg)
SOAK_MINUTES ?= 30
soak:
	$(PY) -u tools/longfuzz.py $(SOAK_MINUTES)

# regenerate graph.png + doc tables from the latest driver-captured bench JSON
BENCH_JSON ?= $(lastword $(sort $(wildcard BENCH_r*.json)))
graph:
	$(PY) tools/graph.py $(BENCH_JSON) graph.png

docs:
	$(PY) tools/regen_docs.py $(BENCH_JSON)
	$(PY) tools/graph.py $(BENCH_JSON) graph.png
