"""lidar_graph_slam_tpu — LiDAR graph-SLAM engine in JAX/XLA.

Brand-new implementation of the capability set of the ROS 2 + PCL + GTSAM reference stack
`RyuYamamoto/lidar_graph_slam` (see SURVEY.md for the structural map): prefiltering,
NDT/GICP/ICP scan-to-submap odometry, keyframing, pose-graph SLAM with loop closure, map
assembly/export — re-designed as fixed-shape device programs rather than ported.
"""

import jax as _jax

# SLAM pose chains and 6x6 normal equations are numerically fragile: a GPU's default
# float32 matmul precision rounds the inputs to TF32 (10-bit mantissa), which costs
# registration accuracy. Pin full float32 products engine-wide.
_jax.config.update("jax_default_matmul_precision", "highest")

# The persistent compilation cache is not enabled at import: the accelerator entry points
# (bench.py, the CLI, chip_smoke.py) enable it via utils.jit_cache.enable_compilation_cache().

__version__ = "0.1.0"
