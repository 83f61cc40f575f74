"""
Gridder accuracy against the explicit DFT oracle, and invert/predict
adjoint consistency.

This is the framework's equivalent of the reference's correctness
contract: the ducc0 wgridder is invoked at epsilon=1e-4
(reference: src/ska_sdp_cip/invert.py:179) and ducc0 itself is
validated against this same brute-force DFT.
"""

import numpy as np
import pytest

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops.dft import dirty_image_dft
from ska_sdp_cip_tpu.ops.gridder import (
    build_invert,
    build_predict,
    dirty_image,
    plan_device_arrays,
)
from ska_sdp_cip_tpu.ops.plan import make_plan

NPIX = 128
PIXEL_SIZE_LM = float(np.sin(np.radians(40.0 / 3600)))


@pytest.fixture(scope="module")
def small_vis():
    rng = np.random.default_rng(99)
    uvw, _ = synthetic_uvw(4, 10, max_baseline_m=3000.0, seed=5)
    freqs = np.array([1.0e9, 1.05e9])
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis, wgt


@pytest.mark.parametrize("apply_w", [False, True])
def test_invert_matches_dft(small_vis, apply_w):
    uvw, freqs, vis, wgt = small_vis
    reference = dirty_image_dft(
        uvw, freqs, vis, wgt, NPIX, PIXEL_SIZE_LM, apply_w=apply_w
    )
    ours = dirty_image(
        uvw,
        freqs,
        vis,
        wgt,
        NPIX,
        PIXEL_SIZE_LM,
        epsilon=1e-4,
        do_wstacking=apply_w,
    )
    error = np.max(np.abs(ours - reference)) / np.max(np.abs(reference))
    assert error < 1e-4


@pytest.mark.parametrize("sigma", [1.5, "auto"])
def test_invert_matches_dft_at_reduced_oversampling(small_vis, sigma):
    """
    The epsilon=1e-4 contract must hold at sigma=1.5 (the FFT-
    dominated production choice: 44% smaller padded grid per w-plane,
    support 8 instead of 6) and under the auto cost-model choice.
    """
    uvw, freqs, vis, wgt = small_vis
    reference = dirty_image_dft(
        uvw, freqs, vis, wgt, NPIX, PIXEL_SIZE_LM, apply_w=True
    )
    ours = dirty_image(
        uvw,
        freqs,
        vis,
        wgt,
        NPIX,
        PIXEL_SIZE_LM,
        epsilon=1e-4,
        do_wstacking=True,
        sigma=sigma,
    )
    error = np.max(np.abs(ours - reference)) / np.max(np.abs(reference))
    assert error < 1e-4


def test_resolve_sigma_regimes():
    """FFT-dominated -> 1.5; visibility-dominated -> 2.0."""
    from ska_sdp_cip_tpu.ops.plan import nm1_min_of, resolve_sigma

    nm1 = nm1_min_of(10240, float(np.sin(np.radians(1.1 / 3600))))
    # Production config: 258k vis on a 10240-px wide field
    assert (
        resolve_sigma(258_000, 10240, w_extent=5000.0, nm1_min=nm1)
        == 1.5
    )
    # Bench config: 5.8M vis on a 2048-px image with the actual bench
    # w extent (~3000 wavelengths at 7.7 km baselines).
    nm1_small = nm1_min_of(2048, float(np.sin(np.radians(5.0 / 3600))))
    assert (
        resolve_sigma(
            5_800_000, 2048, w_extent=3000.0, nm1_min=nm1_small
        )
        == 2.0
    )


def test_accuracy_improves_with_epsilon(small_vis):
    uvw, freqs, vis, wgt = small_vis
    reference = dirty_image_dft(
        uvw, freqs, vis, wgt, NPIX, PIXEL_SIZE_LM, apply_w=True
    )
    errors = []
    for epsilon in (1e-3, 1e-5):
        ours = dirty_image(
            uvw,
            freqs,
            vis,
            wgt,
            NPIX,
            PIXEL_SIZE_LM,
            epsilon=epsilon,
            do_wstacking=True,
        )
        errors.append(
            np.max(np.abs(ours - reference)) / np.max(np.abs(reference))
        )
    assert errors[1] < errors[0]
    assert errors[1] < 1e-4


@pytest.mark.parametrize("apply_w", [False, True])
def test_predict_is_adjoint_of_invert(small_vis, apply_w):
    """
    <invert(v), img> == Re <v, predict(img)>: the dot-product test that
    guarantees correct major-cycle gradients.
    """
    import jax.numpy as jnp

    from ska_sdp_cip_tpu.ops.gridder import split_complex

    uvw, freqs, vis, wgt = small_vis
    plan = make_plan(
        uvw,
        freqs,
        NPIX,
        PIXEL_SIZE_LM,
        epsilon=1e-4,
        do_wstacking=apply_w,
    )
    arrays = plan_device_arrays(plan)
    invert = build_invert(plan)
    predict = build_predict(plan)

    rng = np.random.default_rng(7)
    vis_flat = (vis * wgt).ravel().astype(np.complex64)
    vr, vi = split_complex(vis_flat)
    padded = np.zeros(plan.num_vis, np.float32)
    vr_pad, vi_pad = padded.copy(), padded.copy()
    vr_pad[: len(vr)], vi_pad[: len(vi)] = vr, vi
    image = rng.normal(size=(NPIX, NPIX)).astype(np.float32)

    dirty = np.asarray(
        invert(arrays, jnp.asarray(vr_pad), jnp.asarray(vi_pad))
    )
    out_re, out_im = predict(arrays, jnp.asarray(image))
    model_vis = np.asarray(out_re) + 1j * np.asarray(out_im)

    lhs = float(np.vdot(image, dirty))
    rhs = float(np.real(np.vdot(model_vis, vis_flat)))
    assert lhs == pytest.approx(rhs, rel=1e-4)


def test_predict_matches_dft_point_source():
    """
    Forward model check: predicting from a delta image reproduces the
    analytic point-source visibilities.
    """
    from ska_sdp_cip_tpu.ops.dft import predict_dft
    from ska_sdp_cip_tpu.ops.gridder import predict_visibilities

    uvw, _ = synthetic_uvw(2, 6, max_baseline_m=2000.0, seed=3)
    freqs = np.array([1.2e9])

    npix = 64
    image = np.zeros((npix, npix), np.float32)
    image[npix // 2 + 5, npix // 2 - 3] = 1.7
    image[npix // 2 - 9, npix // 2 + 8] = 0.8

    reference = predict_dft(uvw, freqs, image, PIXEL_SIZE_LM, apply_w=True)
    ours = predict_visibilities(
        uvw, freqs, image, PIXEL_SIZE_LM, epsilon=1e-5, do_wstacking=True
    )
    error = np.max(np.abs(ours - reference)) / np.max(np.abs(reference))
    assert error < 1e-4
