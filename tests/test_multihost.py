"""Multi-host scaffolding exercised WITHOUT hardware: two local processes, two virtual
CPU devices each, Gloo collectives — `jax.distributed.initialize` + a 4-device global
mesh + cross-process submap allgather + the distributed pose-graph solves running across
the process boundary (BASELINE.json configs[4]'s code path;
SURVEY.md §5.8)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_mesh_end_to_end():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert "MULTIHOST_OK" in out, f"worker {i} did not complete:\n{out[-4000:]}"
        assert "MULTIHOST_PIPELINE_OK" in out, f"worker {i} pipeline phase failed:\n{out[-4000:]}"


def test_initialize_from_env_single_process_noop(monkeypatch):
    from lidar_graph_slam_tpu.parallel import multihost

    monkeypatch.delenv("LGS_COORDINATOR", raising=False)
    monkeypatch.delenv("LGS_NUM_PROCESSES", raising=False)
    assert multihost.initialize_from_env() is False


def test_host_sharded_store_single_process():
    """n_proc=1 degrades to a plain local store with local submap assembly."""
    from lidar_graph_slam_tpu.parallel.multihost import HostShardedKeyframeStore

    store = HostShardedKeyframeStore(pad_points=32, process_id=0, num_processes=1)
    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(16, 3)).astype(np.float32) for _ in range(4)]
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for k in range(4):
        poses[k, 1, 3] = 2.0 * k
        store.add(k, clouds[k])
    sub = store.assemble_submap(1, 3, poses)
    expected = np.concatenate([
        clouds[1] + np.array([0, 2.0, 0], np.float32),
        clouds[2] + np.array([0, 4.0, 0], np.float32),
    ])
    np.testing.assert_allclose(sub, expected, atol=1e-6)

    # Ownership bookkeeping in the 2-process view.
    s2 = HostShardedKeyframeStore(pad_points=32, process_id=1, num_processes=2)
    s2.add(0, None)  # not owned: metadata only
    s2.add(1, clouds[1])
    assert s2.local_ids() == [1]
    assert s2.n_keyframes == 2
    with pytest.raises(ValueError):
        s2.add(3, None)  # owned but no cloud supplied
