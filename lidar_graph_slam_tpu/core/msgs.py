"""Typed wire schema — the engine's equivalent of `lidar_graph_slam_msgs`.

The reference defines its inter-process contract as ROS IDL messages
(`lidar_graph_slam_msgs/msg/KeyFrame.msg:1-5`: header, PointCloud2 cloud, Pose pose,
float64 accum_distance, int64 id; `msg/KeyFrameArray.msg:1`; `srv/SaveMap.srv:1-4`:
resolution + path -> ret). Here the three DDS processes collapse into one pipeline, so the
"wire" is a function boundary — but the schema stays first-class: the front end emits
`KeyFrame` records, the back end consumes them, and checkpoints / multi-host shipping
serialize `KeyFrameArray` losslessly to npz.

Design notes: clouds are carried as fixed-capacity padded arrays + boolean
masks — the shape contract every jitted consumer (loop-closure ICP, map assembly) relies
on — rather than ragged PointCloud2 blobs. `header` becomes {stamp, frame_index}: there is
no TF tree; frames are implicit (sensor-frame cloud + map-frame pose, matching what the
reference actually ships after `lidar_scan_matcher.cpp:196`).

`KeyFrame` supports mapping-style access (`kf["pose"]`) so schema records and plain dicts
are interchangeable at the front-end/back-end boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class KeyFrame:
    """One keyframe record (msg/KeyFrame.msg:1-5).

    cloud: [N, 3] float32, sensor/base frame, padded to capacity; cloud_mask: [N] bool.
    pose: [4, 4] float32 map-frame pose. accum_distance: trajectory arc length at this
    keyframe (`lidar_scan_matcher.cpp:185`). id: keyframe index (`:190`).
    """

    id: int
    pose: np.ndarray
    cloud: np.ndarray
    cloud_mask: np.ndarray
    accum_distance: float
    frame_index: int = -1       # scan index that produced this keyframe (header seq)
    stamp: Optional[float] = None  # sensor timestamp (header stamp), None if unstamped

    def __getitem__(self, key: str):
        return getattr(self, key)

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    @property
    def num_points(self) -> int:
        return int(np.sum(self.cloud_mask))

    def valid_points(self) -> np.ndarray:
        """Unpadded [n, 3] view of the cloud."""
        return self.cloud[self.cloud_mask]

    @classmethod
    def from_dict(cls, d: dict) -> "KeyFrame":
        return cls(
            id=int(d["id"]),
            pose=np.asarray(d["pose"], dtype=np.float32),
            cloud=np.asarray(d["cloud"], dtype=np.float32),
            cloud_mask=np.asarray(d["cloud_mask"], dtype=bool),
            accum_distance=float(d["accum_distance"]),
            frame_index=int(d.get("frame_index", -1)),
            stamp=d.get("stamp"),
        )


@dataclasses.dataclass
class KeyFrameArray:
    """Ordered keyframe collection (msg/KeyFrameArray.msg:1) + lossless npz round-trip."""

    keyframes: List[KeyFrame] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.keyframes)

    def __iter__(self) -> Iterator[KeyFrame]:
        return iter(self.keyframes)

    def __getitem__(self, i: int) -> KeyFrame:
        return self.keyframes[i]

    def append(self, kf: KeyFrame) -> None:
        self.keyframes.append(kf)

    def poses(self) -> np.ndarray:
        """[K, 4, 4] stacked poses."""
        return np.stack([kf.pose for kf in self.keyframes]).astype(np.float32)

    def save(self, path: str) -> None:
        """Serialize to npz. Clouds are stored unpadded (ragged -> concatenated + offsets)
        so capacity choices do not leak into the artifact."""
        k = len(self.keyframes)
        pts = [kf.valid_points() for kf in self.keyframes]
        counts = np.array([p.shape[0] for p in pts], dtype=np.int64)
        np.savez_compressed(
            path,
            ids=np.array([kf.id for kf in self.keyframes], dtype=np.int64),
            poses=self.poses() if k else np.zeros((0, 4, 4), np.float32),
            accum=np.array([kf.accum_distance for kf in self.keyframes], np.float64),
            frame_index=np.array([kf.frame_index for kf in self.keyframes], np.int64),
            stamps=np.array(
                [np.nan if kf.stamp is None else kf.stamp for kf in self.keyframes],
                np.float64,
            ),
            counts=counts,
            points=np.concatenate(pts).astype(np.float32) if k else np.zeros((0, 3), np.float32),
        )

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None) -> "KeyFrameArray":
        """Load from npz; clouds re-padded to `capacity` (default: max count, rounded up to
        a multiple of 256 for stable jit shapes)."""
        z = np.load(path)
        counts = z["counts"]
        if capacity is None:
            m = int(counts.max()) if counts.size else 256
            capacity = max(256, -(-m // 256) * 256)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        out = cls()
        for i in range(len(counts)):
            n = int(counts[i])
            if n > capacity:
                raise ValueError(f"keyframe {i} has {n} points > capacity {capacity}")
            cloud = np.zeros((capacity, 3), np.float32)
            cloud[:n] = z["points"][offsets[i]: offsets[i + 1]]
            mask = np.zeros((capacity,), bool)
            mask[:n] = True
            stamp = float(z["stamps"][i])
            out.append(
                KeyFrame(
                    id=int(z["ids"][i]),
                    pose=z["poses"][i],
                    cloud=cloud,
                    cloud_mask=mask,
                    accum_distance=float(z["accum"][i]),
                    frame_index=int(z["frame_index"][i]),
                    stamp=None if np.isnan(stamp) else stamp,
                )
            )
        return out


@dataclasses.dataclass
class SaveMapRequest:
    """srv/SaveMap.srv request: voxel resolution (0 = raw) + output path."""

    resolution: float
    path: str


@dataclasses.dataclass
class SaveMapResponse:
    """srv/SaveMap.srv response."""

    ret: bool
