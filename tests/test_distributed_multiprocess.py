"""
REAL multi-process distributed invert == local invert.

The reference's oracle runs dask invert on a 2-worker LocalCluster and
requires the image to match the local one at epsilon=1e-5
(reference: tests/test_dask_invert_measurement_set.py:12-34 over
tests/fixtures/dask_cluster.py:9-32). The in-process 8-device CPU mesh
used elsewhere in this suite cannot execute ``process_count() > 1``
code paths; this test spawns 2 actual processes that join one SPMD
world via ``jax.distributed`` (local coordinator, gloo CPU
collectives, one device each) and runs ``sharded_invert_dataset``
across them — executing ``initialize_distributed``, the host
allgathers, per-process shard staging, and a cross-process psum for
real.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from ska_sdp_cip_tpu import invert_dataset

NUM_PIXELS = 128
PIXEL_SIZE_ASEC = 15.0
WORKER = Path(__file__).parent / "helpers" / "distributed_invert_worker.py"
CLEAN_WORKER = (
    Path(__file__).parent / "helpers" / "distributed_clean_worker.py"
)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_two_process_invert_matches_local(reader, dataset_path, tmp_path):
    local = invert_dataset(reader, NUM_PIXELS, PIXEL_SIZE_ASEC)

    out_path = tmp_path / "distributed.npy"
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker pins its own device count
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [
                sys.executable,
                str(WORKER),
                str(pid),
                "2",
                str(port),
                str(dataset_path),
                str(out_path),
                str(NUM_PIXELS),
                str(PIXEL_SIZE_ASEC),
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outputs = []
    for proc in procs:
        stdout, _ = proc.communicate(timeout=600)
        outputs.append(stdout.decode(errors="replace"))
    for proc, output in zip(procs, outputs):
        assert proc.returncode == 0, (
            f"worker failed (rc={proc.returncode}):\n{output}"
        )

    distributed = np.load(out_path)
    assert distributed.shape == (NUM_PIXELS, NUM_PIXELS)
    # The reference's tolerance: eps=1e-5 (rtol; atol = eps * max|img|)
    eps = 1e-5
    np.testing.assert_allclose(
        distributed,
        local,
        rtol=eps,
        atol=eps * np.abs(local).max(),
    )


def test_two_process_distributed_fft_matches_local(
    reader, dataset_path, tmp_path
):
    """
    fft_mode="distributed" across 2 REAL processes: psum_scatter,
    all_to_all, and all_gather run over gloo process boundaries (the
    in-process mesh cannot exercise these cross-process paths).
    """
    local = invert_dataset(reader, NUM_PIXELS, PIXEL_SIZE_ASEC)

    out_path = tmp_path / "distributed_fft.npy"
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [
                sys.executable,
                str(WORKER),
                str(pid),
                "2",
                str(port),
                str(dataset_path),
                str(out_path),
                str(NUM_PIXELS),
                str(PIXEL_SIZE_ASEC),
                "distributed",
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outputs = []
    for proc in procs:
        stdout, _ = proc.communicate(timeout=600)
        outputs.append(stdout.decode(errors="replace"))
    for proc, output in zip(procs, outputs):
        assert proc.returncode == 0, (
            f"worker failed (rc={proc.returncode}):\n{output}"
        )

    distributed = np.load(out_path)
    eps = 1e-5
    np.testing.assert_allclose(
        distributed,
        local,
        atol=eps * np.abs(local).max(),
        rtol=eps,
    )


def test_two_process_major_cycle_matches_single_process(
    reader, dataset_path, tmp_path
):
    """
    The SHIPPED top-level program — ``sharded_major_cycle_clean`` with
    checkpointing — across 2 REAL processes, vs the same algorithm on
    the in-process 2-device mesh (identical sharding, so the match is
    tight). Exercises the cross-process PSF build, per-cycle
    predict/invert psums, minor-cycle reductions and the checkpoint
    write path, which the invert tests above never touch.
    """
    from ska_sdp_cip_tpu.parallel.mesh import make_device_mesh
    from ska_sdp_cip_tpu.parallel.sharded_clean import (
        sharded_major_cycle_clean,
    )

    from helpers.distributed_clean_worker import CLEAN_KWARGS

    model_sp, residual_sp, _psf = sharded_major_cycle_clean(
        reader,
        NUM_PIXELS,
        PIXEL_SIZE_ASEC,
        mesh=make_device_mesh(2),
        **CLEAN_KWARGS,
    )

    out_path = tmp_path / "clean2p.npz"
    ckpt_dir = tmp_path / "ckpt"
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [
                sys.executable,
                str(CLEAN_WORKER),
                str(pid),
                "2",
                str(port),
                str(dataset_path),
                str(out_path),
                str(NUM_PIXELS),
                str(PIXEL_SIZE_ASEC),
                str(ckpt_dir),
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outputs = []
    for proc in procs:
        stdout, _ = proc.communicate(timeout=900)
        outputs.append(stdout.decode(errors="replace"))
    for proc, output in zip(procs, outputs):
        assert proc.returncode == 0, (
            f"clean worker failed (rc={proc.returncode}):\n{output}"
        )

    result = np.load(out_path)
    eps = 1e-5
    scale = np.abs(np.asarray(residual_sp)).max()
    np.testing.assert_allclose(
        result["model"], np.asarray(model_sp), atol=eps * scale, rtol=eps
    )
    np.testing.assert_allclose(
        result["residual"],
        np.asarray(residual_sp),
        atol=eps * scale,
        rtol=eps,
    )
    # The checkpoint path ran (cycle checkpoints flushed then cleared
    # or retained — the directory must exist and have been written).
    assert ckpt_dir.exists()
