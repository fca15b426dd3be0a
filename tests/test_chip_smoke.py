"""`chip_smoke.py` refuses to run without a GPU: no CPU fallback, no result line."""

import json

import pytest

import chip_smoke


def test_require_gpu_refuses_cpu_backend():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)


def test_main_exits_nonzero_without_result_line(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_pose_diff_measures_small_rotations_exactly():
    import numpy as np

    a = np.eye(4, dtype=np.float32)
    b = np.eye(4, dtype=np.float32)
    t = 1e-4  # rad about z, below what arccos of a float32 trace could resolve
    b[:2, :2] = [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]
    b[0, 3] = 0.25
    dt, dr = chip_smoke._pose_diff(a, b)
    assert dt == pytest.approx(0.25)
    assert dr == pytest.approx(t, rel=1e-3)
