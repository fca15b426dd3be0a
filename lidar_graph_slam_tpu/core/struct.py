"""Pytree dataclasses: frozen dataclasses whose fields are JAX pytree leaves.

Every device-side record in the engine (point clouds, voxel maps, registration results,
front-end state, the pose graph) is one of these, so it can cross `jit`, `vmap`,
`lax.scan` and `jax.tree.map` boundaries as a single argument.
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    """Return a copy with `changes` applied (`dataclasses.replace`)."""
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Decorate `cls` as a frozen dataclass registered with `jax.tree_util`.

    Every field is a data field (a pytree child), in declaration order. The class gains
    a `.replace(**changes)` method returning an updated copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
