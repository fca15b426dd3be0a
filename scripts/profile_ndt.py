"""Profile the NDT align hot path on the default device: stage-level timing breakdown.

Usage: `python scripts/profile_ndt.py` from the repo root, on a machine with a GPU.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from lidar_graph_slam_tpu.utils.jit_cache import enable_compilation_cache

enable_compilation_cache()

from lidar_graph_slam_tpu.core.config import NdtConfig
from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.io.synthetic import make_world, make_loop_trajectory, simulate_scan
from lidar_graph_slam_tpu.registration.base import ndt_accumulate_xla
from lidar_graph_slam_tpu.registration.ndt import make_ndt_matcher, ndt_align
from lidar_graph_slam_tpu.ops.voxel import build_ndt_map, lookup_direct7
from lidar_graph_slam_tpu.core import se3


def timeit(fn, *args, n=20, warmup=2):
    for _ in range(warmup):
        r = fn(*args)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n * 1e3  # ms


def main():
    print("device:", jax.devices()[0].platform, jax.devices()[0].device_kind)
    rng = np.random.default_rng(0)
    world = make_world(rng, extent=60.0, density=4.0)
    traj = make_loop_trajectory(40, radius=35.0, laps=0.3)

    scan_capacity = 16384
    cfg = NdtConfig()
    build_target, align = make_ndt_matcher(cfg, map_capacity=65536)

    submap_pts = []
    for i in range(0, 20):
        s = simulate_scan(world, traj[i], rng, max_points=8192, noise=0.02)
        submap_pts.append(s @ traj[i][:3, :3].T + traj[i][:3, 3])
    submap = np.concatenate(submap_pts).astype(np.float32)
    sub_cloud = PointCloud.from_array(submap, capacity=262144)
    target = build_target(sub_cloud.points, sub_cloud.mask)

    s = simulate_scan(world, traj[20], rng, max_points=scan_capacity, noise=0.02)
    cloud = PointCloud.from_array(s, capacity=scan_capacity)
    guess = jnp.asarray(traj[19])

    # Full align
    t_align = timeit(lambda: align(target, cloud.points, cloud.mask, guess))
    r = align(target, cloud.points, cloud.mask, guess)
    print(f"align: {t_align:.3f} ms   iters={int(r.iterations)} fitness={float(r.fitness):.4f}")

    # Target build
    t_build = timeit(lambda: build_target(cloud.points, cloud.mask))
    print(f"build_target (16k pts): {t_build:.3f} ms")

    vm = target if not isinstance(target, tuple) else target[1]

    # One iteration's pieces
    p = se3.transform_points(guess.astype(jnp.float32), cloud.points)

    lk = jax.jit(lambda vm, p: lookup_direct7(vm, p))
    t_lookup = timeit(lambda: lk(vm, p))
    print(f"lookup_direct7 (16k x 7): {t_lookup:.3f} ms")

    means, icovs, hit = lk(vm, p)
    n = p.shape[0]
    e = (p[:, None, :] - means).reshape(n * 7, 3)
    ic = icovs.reshape(n * 7, 3, 3)
    pr = jnp.broadcast_to(p[:, None, :], (n, 7, 3)).reshape(n * 7, 3)
    hm = (hit & cloud.mask[:, None]).reshape(n * 7)
    acc = jax.jit(ndt_accumulate_xla)
    t_acc = timeit(lambda: acc(e, ic, pr, hm, 1.0, 1.0))
    print(f"ndt_accumulate_xla (114k corr): {t_acc:.3f} ms")

    # transform_points alone
    tp = jax.jit(se3.transform_points)
    t_tp = timeit(lambda: tp(guess.astype(jnp.float32), cloud.points))
    print(f"transform_points: {t_tp:.3f} ms")

    # Single fused iteration estimate: iterate align with max_iterations=1
    t1 = timeit(lambda: ndt_align(vm, cloud.points, cloud.mask, guess,
                                  max_iterations=1, polish_iterations=0))
    t2 = timeit(lambda: ndt_align(vm, cloud.points, cloud.mask, guess,
                                  max_iterations=2, polish_iterations=0))
    t8 = timeit(lambda: ndt_align(vm, cloud.points, cloud.mask, guess,
                                  max_iterations=8, polish_iterations=0))
    print(f"align(max_it=1): {t1:.3f} ms  (max_it=2): {t2:.3f}  (max_it=8): {t8:.3f}  per-iter ~{(t8-t1)/7:.3f} ms")

    # Roofline for the fused accumulation: the kernel reads 61 B and
    # does ~220 FLOP per correspondence row — arithmetic intensity ~3.6 FLOP/B, firmly
    # bandwidth-bound, so achieved-bytes/s vs the chip's measured streaming peak IS the
    # speed-of-light fraction. The peak is self-calibrated (saxpy on 256 MiB).
    xbig = jnp.ones((64 * 1024 * 1024,), jnp.float32)
    saxpy = jax.jit(lambda v: v * 1.0001 + 1.0)
    t_peak = timeit(lambda: saxpy(xbig), n=10)
    peak_gbs = (2 * xbig.size * 4) / (t_peak * 1e-3) / 1e9
    kk = e.shape[0]
    bytes_moved = kk * (12 + 36 + 12 + 1)
    achieved = bytes_moved / (t_acc * 1e-3) / 1e9
    print(f"roofline: ndt_accumulate_xla {achieved:.1f} GB/s vs streaming peak {peak_gbs:.1f} GB/s "
          f"-> {achieved / peak_gbs:.1%} of HBM roofline "
          f"({kk * 220 / (t_acc * 1e-3) / 1e9:.1f} GFLOP/s)")


if __name__ == "__main__":
    main()
