"""`core.struct.pytree_dataclass`: the engine's pytree records behave as JAX pytrees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.core.struct import pytree_dataclass


@pytree_dataclass
class Pair:
    a: jax.Array
    b: jax.Array

    @property
    def total(self):
        return self.a + self.b


def test_flatten_unflatten_round_trip():
    p = Pair(a=jnp.arange(3.0), b=jnp.ones((2, 2)))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert [x.shape for x in leaves] == [(3,), (2, 2)]  # declaration order
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(q, Pair)
    np.testing.assert_array_equal(q.a, p.a)
    np.testing.assert_array_equal(q.b, p.b)
    doubled = jax.tree.map(lambda x: 2 * x, p)
    np.testing.assert_array_equal(doubled.b, 2 * np.ones((2, 2)))


def test_replace_returns_updated_copy_and_fields_are_frozen():
    p = Pair(a=jnp.zeros(2), b=jnp.ones(2))
    q = p.replace(b=jnp.full(2, 5.0))
    np.testing.assert_array_equal(q.b, [5.0, 5.0])
    np.testing.assert_array_equal(p.b, [1.0, 1.0])  # original untouched
    assert q.a is p.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)
    with pytest.raises(TypeError):
        p.replace(c=1)


def test_jit_takes_and_returns_the_record():
    @jax.jit
    def step(p: Pair) -> Pair:
        return p.replace(a=p.a + 1.0, b=p.total)

    out = step(Pair(a=jnp.arange(3.0), b=jnp.full(3, 2.0)))
    assert isinstance(out, Pair)
    np.testing.assert_array_equal(out.a, [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(out.b, [2.0, 3.0, 4.0])


def test_vmap_and_scan_through_an_engine_record():
    clouds = PointCloud(points=jnp.arange(24.0).reshape(2, 4, 3),
                        mask=jnp.array([[True, True, False, False], [True] * 4]))
    counts = jax.vmap(lambda c: c.count())(clouds)
    np.testing.assert_array_equal(counts, [2, 4])

    def body(carry, c):
        return carry + c.count(), c.replace(points=c.points * 0.0)

    total, zeroed = jax.lax.scan(body, jnp.int32(0), clouds)
    assert int(total) == 6
    assert isinstance(zeroed, PointCloud) and float(jnp.abs(zeroed.points).sum()) == 0.0
