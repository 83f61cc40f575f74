"""
CLI end-to-end tests (reference: tests/test_pipeline_app.py:12-76):
run_program with and without distribution, asserting the output .npy
exists with the right shape, plus the installed entry point.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ska_sdp_cip_tpu.apps.pipeline_app import run_program


def test_local_invert_cli(dataset_path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "image.npy"
    run_program(
        [str(dataset_path), str(out), "-n", "128", "-p", "30.0"]
    )
    image = np.load(out)
    assert image.shape == (128, 128)


def test_distributed_invert_cli(dataset_path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "image_dist.npy"
    run_program(
        [
            str(dataset_path),
            str(out),
            "-n",
            "128",
            "-p",
            "30.0",
            "-d",
            "8",
            "-rc",
            "2",
            "-fc",
            "4",
        ]
    )
    image = np.load(out)
    assert image.shape == (128, 128)
    # task-list.json written in the reference schema
    tasks = json.loads((tmp_path / "task-list.json").read_text())
    assert {t["name"] for t in tasks} == {
        "load_shards",
        "plan_shards",
        "stage_shards",
        "grid_fft_reduce",
    }
    assert set(tasks[0]) == {
        "key",
        "worker",
        "status",
        "start",
        "stop",
        "name",
        "duration",
    }


def test_version_flag(capsys):
    with pytest.raises(SystemExit):
        run_program(["--version"])
    assert capsys.readouterr().out.strip()


def test_entry_point_subprocess(dataset_path, tmp_path):
    """The console script runs as an installed entry point."""
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # Works from a source checkout without an editable install.
    repo_root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo_root, env.get("PYTHONPATH")) if p
    )

    out = tmp_path / "sub.npy"
    result = subprocess.run(
        [
            sys.executable,
            "-m",
            "ska_sdp_cip_tpu.apps.pipeline_app",
            str(dataset_path),
            str(out),
            "-n",
            "64",
            "-p",
            "30.0",
        ],
        capture_output=True,
        text=True,
        cwd=tmp_path,
        timeout=600,
        env=env,
    )
    assert result.returncode == 0, result.stderr
    assert np.load(out).shape == (64, 64)
