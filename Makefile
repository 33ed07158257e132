# thor_slam_tpu operator targets (the reference's Makefile role).

PY ?= python
CONFIG ?= config/slam_config.yaml
FRAMES ?=
NUM_CAMERAS ?= 4

.PHONY: help
help:
	@grep -E '^[a-z-]+:.*##' Makefile | sed 's/:.*##/\t/'

# ----------------------------- run -----------------------------

.PHONY: slam-run
slam-run: ## Run SLAM tracking (config: CONFIG=...)
	$(PY) -m scripts.run_slam --config $(CONFIG) $(if $(FRAMES),--frames $(FRAMES))

.PHONY: slam-run-synthetic
slam-run-synthetic: ## Run SLAM on the hardware-free synthetic rig
	$(PY) -m scripts.run_slam --synthetic $(if $(FRAMES),--frames $(FRAMES))

.PHONY: pipeline-run
pipeline-run: ## Run SLAM + RGB-D product streams
	$(PY) -m scripts.run_pipeline --config $(CONFIG) $(if $(FRAMES),--frames $(FRAMES))

.PHONY: map-demo
map-demo: ## Dense-mapping demo: synthetic rig -> TSDF -> mesh.ply + map.npz (no hardware)
	$(PY) -m scripts.run_pipeline --synthetic --frames 40 --rgbd-every 2 --map \
		--save-dense-map /tmp/thor_dense_map.npz --save-ply /tmp/thor_mesh.ply

.PHONY: odom-tf
odom-tf: ## Broadcast map->odom TF (requires rclpy)
	$(PY) -m scripts.publish_odom_tf

.PHONY: euroc-run
euroc-run: ## Evaluate ATE on a EuRoC sequence: make euroc-run EUROC=/path/MH_01_easy
ifndef EUROC
	$(error Set EUROC to a EuRoC sequence directory, e.g. make euroc-run EUROC=/data/euroc/MH_01_easy)
endif
	$(PY) -m scripts.run_euroc --sequence $(EUROC)

.PHONY: euroc-selftest
euroc-selftest: ## Generate a synthetic ASL-layout sequence and evaluate ATE on it
	$(PY) -m scripts.make_euroc_synthetic --out /tmp/thor_synseq --frames 50
	$(PY) -m scripts.run_euroc --sequence /tmp/thor_synseq --frames 50

.PHONY: euroc-selftest-loop
euroc-selftest-loop: ## 3-orbit noisy sequence where loop closures fire organically (BASELINE.md)
	$(PY) -m scripts.make_euroc_synthetic --out /tmp/thor_loopseq --frames 1100 \
		--width 320 --height 200 --trajectory-rate 0.35 --noise-std 6
	$(PY) -m scripts.run_euroc --sequence /tmp/thor_loopseq

# ------------------------- ROS 2 interop -------------------------
# (reference Makefile isaac-ros-launch / nvblox-launch / rviz targets)

.PHONY: slam-launch
slam-launch: ## ROS 2: SLAM bridge + map->odom TF (requires ros2/rclpy)
	ros2 launch launch/thor_slam_tpu.launch.py config:=$(CONFIG)

.PHONY: nvblox-launch
nvblox-launch: ## ROS 2: nvblox fed by our RGB-D topics (requires nvblox_ros)
	ros2 launch launch/thor_nvblox.launch.py

.PHONY: rviz
rviz: ## RViz2 with the visual-SLAM layout
	rviz2 -d config/visual_slam.rviz

.PHONY: rviz-nvblox
rviz-nvblox: ## RViz2 with the nvblox layout
	rviz2 -d config/nvblox.rviz

# --------------------------- hardware ---------------------------

.PHONY: find-cameras
find-cameras: ## List DepthAI devices on the network
	$(PY) -m scripts.find_cameras

.PHONY: set-ip
set-ip: ## Flash a camera IP: make set-ip ARGS="<cur-ip> --static <new-ip>"
	$(PY) -m scripts.set_ip $(ARGS)

# ----------------------------- dev ------------------------------

.PHONY: test
test: ## Quick test tier (~2-3 min; skips slow e2e/numerics, virtual 8-device CPU mesh)
	$(PY) -m pytest tests/ -x -q -m "not slow"

.PHONY: test-all
test-all: ## Full test suite incl. slow e2e/SPMD/numerics (~15 min on 1 core)
	$(PY) -m pytest tests/ -x -q

.PHONY: bench
bench: ## Headline benchmark on the attached GPU
	$(PY) bench.py

.PHONY: chip-smoke
chip-smoke: ## Main path on the attached GPU, checked against CPU and the kernels' references
	$(PY) chip_smoke.py

.PHONY: profile
profile: ## Per-stage device timing of the tracker
	$(PY) -m scripts.profile_stages 640x400 4


.PHONY: format
format: ## Format (ruff, if available)
	-ruff format thor_slam_tpu tests scripts

.PHONY: static-checks
static-checks: ## Lint (ruff, if available)
	-ruff check thor_slam_tpu tests scripts
