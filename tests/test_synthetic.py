"""The synthetic world's ring road: buildings and pillars stand off the driven circle."""

import numpy as np
import pytest

from lidar_graph_slam_tpu.io.synthetic import _off_road, make_world


@pytest.mark.parametrize("seed", [0, 2])
def test_road_keeps_structures_off_the_circle(seed):
    radius, half_width = 35.0, 4.0
    world = make_world(np.random.default_rng(seed), extent=60.0, density=2.0,
                       wall_height=12.0, box_height=(6.0, 25.0), n_boxes=60,
                       road=(radius, half_width))
    r = np.hypot(world[:, 0], world[:, 1])
    above_ground = world[:, 2] > 0.0
    # 0.3 m of slack covers the pillars' 5 cm position noise.
    on_road = np.abs(r - radius) < half_width - 0.3
    assert not np.any(on_road & above_ground)
    # The ground itself still covers the road.
    assert np.any(on_road & ~above_ground)


def test_without_road_structures_may_stand_on_the_circle():
    world = make_world(np.random.default_rng(2), extent=60.0, density=2.0,
                       wall_height=12.0, box_height=(6.0, 25.0), n_boxes=60)
    r = np.hypot(world[:, 0], world[:, 1])
    assert np.any((np.abs(r - 35.0) < 3.7) & (world[:, 2] > 0.0))


@pytest.mark.parametrize("footprint, clear", [
    ((0.0, 0.0, 5.0, 5.0), True),     # inside the ring
    ((35.0, 0.0, 1.0, 1.0), False),   # on the road
    ((45.0, 0.0, 1.0, 1.0), True),    # outside the ring
    ((45.0, 0.0, 7.0, 1.0), False),   # its near face reaches the road
    ((20.0, 20.0, 2.0, 2.0), False),  # corner of the footprint on the road
])
def test_off_road_footprint(footprint, clear):
    assert _off_road((35.0, 4.0), *footprint) is clear
    assert _off_road(None, *footprint)
