# Build/test entry points. The native library also auto-builds on first use.
PY ?= python

.PHONY: native test test-gpu bench smoke clean

native:
	$(PY) -m pointcloud_stitching_tpu.native.build

native-server:
	g++ -O2 -std=c++17 -o native/pcs-camera-server \
	    native/camera_server.cc native/snappy.cc -lpthread

# live-capture build (real rigs only; needs the librealsense2 SDK)
native-server-rs2:
	g++ -O2 -std=c++17 -DPCS_WITH_RS2 -o native/pcs-camera-server \
	    native/camera_server.cc native/snappy.cc -lpthread -lrealsense2

# CI syntax check of the rs2 path against the stub headers (no SDK here)
native-server-rs2check:
	g++ -std=c++17 -DPCS_WITH_RS2 -Inative/rs2_stub -fsyntax-only \
	    native/camera_server.cc

cpu-baseline:
	$(PY) scripts/cpu_baseline.py

test: native
	$(PY) -m pytest tests/ -q

# the tests marked gpu, on a machine with an NVIDIA card
test-gpu: native
	PCS_TEST_GPU=1 $(PY) -m pytest tests/ -q -m gpu

# end-to-end check on one GPU (served path, parity, TSDF)
smoke:
	$(PY) chip_smoke.py

bench: native
	$(PY) bench.py

clean:
	rm -f pointcloud_stitching_tpu/native/*.so native/pcs-camera-server
	find . -name __pycache__ -type d -exec rm -rf {} +
