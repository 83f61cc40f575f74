"""
Test configuration: run everything on a virtual 8-device CPU mesh.

The reference tests "multi-node" behaviour with a 2-worker LocalCluster
(reference: tests/fixtures/dask_cluster.py:9-32); here the analog is
8 virtual CPU devices standing in for a multi-GPU host, so sharding,
collectives and SPMD equivalence are exercised for real without GPU
hardware (SURVEY.md section 4). Tests that need a GPU carry the
``gpu`` marker and skip here (see the ``gpu_device`` fixture).
"""

import os

# Must be set before the CPU backend initializes.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The suite runs on the virtual CPU mesh unless told otherwise. A
# process that already holds a GPU (``chip_smoke.py`` runs the
# ``gpu``-marked tests in-process) imported jax before this file, so
# the default cannot move it off the card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ska_sdp_cip_tpu.io.synth import make_synthetic_dataset  # noqa: E402
from ska_sdp_cip_tpu.io.visibility_dataset import (  # noqa: E402
    VisibilityReader,
)


@pytest.fixture(scope="session")
def dataset_path(tmp_path_factory) -> "os.PathLike":
    """
    Session-scoped synthetic VZ dataset — the stand-in for the
    reference's miniature MeerKAT MeasurementSet (whose binary blob is
    absent from the reference snapshot; see tests/data/README.md there).
    8 times x 276 baselines (24 antennas) x 4 channels x 4 pols.
    """
    path = tmp_path_factory.mktemp("data") / "synthetic.vz"
    return make_synthetic_dataset(path, num_times=8, num_antennas=24)


@pytest.fixture(scope="session")
def reader(dataset_path) -> VisibilityReader:
    """Whole-dataset reader."""
    return VisibilityReader(dataset_path)


@pytest.fixture(scope="session")
def weight_column_dataset_path(tmp_path_factory) -> "os.PathLike":
    """Dataset with only a row-level WEIGHT column (fallback path)."""
    path = tmp_path_factory.mktemp("data") / "synthetic_rowweight.vz"
    return make_synthetic_dataset(
        path, num_times=4, num_antennas=12, weight_spectrum=False
    )


@pytest.fixture
def gpu_device():
    """The first GPU, for ``gpu``-marked tests; skips when there is
    none. Decided here, at run time, never at import or collection."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run: python chip_smoke.py)")
    return devices[0]


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(0xC1F)
