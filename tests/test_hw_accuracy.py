"""
On-card accuracy checks (``gpu`` marker): the gridder as compiled for
the GPU against the float64 DFT oracle, and the invert/predict
adjoint identity. The same contract as tests/test_gridder_accuracy.py
(epsilon=1e-4, reference: src/ska_sdp_cip/invert.py:179), which the
CPU suite checks; here it guards against GPU-only numerics such as
float32 products silently running in TF32.

They skip without a GPU. ``python chip_smoke.py`` runs them in-process
on the card (phase 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops.dft import dirty_image_dft
from ska_sdp_cip_tpu.ops.gridder import (
    build_invert,
    build_predict,
    dirty_image,
    plan_device_arrays,
    split_complex,
)
from ska_sdp_cip_tpu.ops.plan import make_plan

pytestmark = pytest.mark.gpu

NPIX = 256
PIXEL_SIZE_LM = float(np.sin(np.radians(20.0 / 3600)))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(101)
    uvw, _ = synthetic_uvw(4, 16, max_baseline_m=4000.0, seed=13)
    freqs = np.array([1.40e9, 1.45e9, 1.50e9])
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis, wgt


@pytest.mark.parametrize("apply_w", [False, True])
def test_invert_matches_dft_on_gpu(gpu_device, problem, apply_w):
    uvw, freqs, vis, wgt = problem
    reference = dirty_image_dft(
        uvw, freqs, vis, wgt, NPIX, PIXEL_SIZE_LM, apply_w=apply_w
    )
    with jax.default_device(gpu_device):
        ours = dirty_image(
            uvw, freqs, vis, wgt, NPIX, PIXEL_SIZE_LM,
            epsilon=1e-4, do_wstacking=apply_w,
        )
    error = np.max(np.abs(ours - reference)) / np.max(np.abs(reference))
    assert error < 1e-4


@pytest.mark.parametrize("apply_w", [False, True])
def test_predict_is_adjoint_of_invert_on_gpu(gpu_device, problem, apply_w):
    uvw, freqs, vis, wgt = problem
    plan = make_plan(
        uvw, freqs, NPIX, PIXEL_SIZE_LM, epsilon=1e-4,
        do_wstacking=apply_w,
    )
    vis_flat = (vis * wgt).ravel().astype(np.complex64)
    vr, vi = split_complex(vis_flat)
    vr_pad = np.zeros(plan.num_vis, np.float32)
    vi_pad = np.zeros(plan.num_vis, np.float32)
    vr_pad[: len(vr)], vi_pad[: len(vi)] = vr, vi
    image = np.random.default_rng(5).normal(size=(NPIX, NPIX))
    image = image.astype(np.float32)
    with jax.default_device(gpu_device):
        arrays = plan_device_arrays(plan)
        dirty = np.asarray(
            build_invert(plan)(
                arrays, jnp.asarray(vr_pad), jnp.asarray(vi_pad)
            )
        )
        out_re, out_im = build_predict(plan)(arrays, jnp.asarray(image))
    model_vis = np.asarray(out_re) + 1j * np.asarray(out_im)
    lhs = float(np.vdot(image, dirty))
    rhs = float(np.real(np.vdot(model_vis, vis_flat)))
    assert lhs == pytest.approx(rhs, rel=1e-4)
