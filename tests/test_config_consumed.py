"""Config honesty: every declared knob must be consumed somewhere in the engine.

Round 2 shipped dead knobs (`IcpConfig.max_correspondence_distance`,
`euclidean_fitness_epsilon`, `GicpConfig.use_reciprocal`) that claimed reference parity
without code behind them. This test makes that class of drift impossible:
each dataclass field in `core/config.py` must appear as an attribute access (`.name`) in
package source outside config.py itself.
"""

import dataclasses
import pathlib
import re

import lidar_graph_slam_tpu.core.config as config_mod

PKG_ROOT = pathlib.Path(config_mod.__file__).resolve().parents[1]


def _all_config_fields():
    fields = set()
    for obj in vars(config_mod).values():
        if dataclasses.is_dataclass(obj) and isinstance(obj, type):
            for f in dataclasses.fields(obj):
                fields.add(f.name)
    return fields


def test_every_config_field_is_consumed():
    source = []
    for py in PKG_ROOT.rglob("*.py"):
        if py.resolve() == pathlib.Path(config_mod.__file__).resolve():
            continue
        source.append(py.read_text())
    blob = "\n".join(source)

    unconsumed = sorted(
        name for name in _all_config_fields()
        if not re.search(r"\." + re.escape(name) + r"\b", blob)
    )
    assert not unconsumed, (
        f"config fields declared but never consumed outside config.py: {unconsumed} — "
        "wire them up or delete them"
    )
