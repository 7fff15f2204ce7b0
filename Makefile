# pffdtd_jax build + test entry points
#
# The compute path is JAX (no build step); `native` builds the
# C++/OpenMP voxelizer backend (also built lazily on first use).

CXX ?= g++
CXXFLAGS ?= -O3 -march=native -fopenmp -shared -fPIC

native: native/build/libpffdtd_vox.so

native/build/libpffdtd_vox.so: native/voxelizer.cpp
	mkdir -p native/build
	$(CXX) $(CXXFLAGS) $< -o $@

test:
	python -m pytest tests/ -x -q

bench:
	python bench.py

clean:
	rm -rf native/build

.PHONY: native test bench clean
