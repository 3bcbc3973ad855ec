# Build the native (C++) host library and run the test-suite.
#
# The native library is optional: everything falls back to NumPy when it is
# absent. `make native` produces bblean_tpu/csrc/build/libbblean_native.so.

CXX ?= g++
# Portable baseline (runs on any 2009+ x86-64); AVX-512 popcount paths are
# compiled via per-function target attributes and picked at run time.
CXXFLAGS ?= -O3 -std=c++17 -fPIC -shared -march=x86-64-v2 -funroll-loops
SRC := bblean_tpu/csrc/bblean_native.cpp
OUT := bblean_tpu/csrc/build/libbblean_native.so

.PHONY: native test test-gpu clean

native: $(OUT)

$(OUT): $(SRC)
	mkdir -p $(dir $(OUT))
	$(CXX) $(CXXFLAGS) -o $(OUT) $(SRC)

test:
	python -m pytest tests/ -x -q

# Run the device tests on the GPU in ONE process (a JAX process reserves
# most of the card's memory): the `gpu`-marked tests plus the kernel and
# batch-engine suites.  The sharded multi-device tests skip on one card.
test-gpu:
	BBLEAN_TPU_TEST_PLATFORM=cuda python -m pytest -p no:xdist -q \
		tests/test_chip_smoke.py tests/test_search_kernels.py \
		tests/test_ops.py tests/test_batch_engine.py

clean:
	rm -rf bblean_tpu/csrc/build
