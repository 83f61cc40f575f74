"""
Compact staging path: on-device slot ordering of the raw data-order
visibilities (conjugation flip and w-shift pre-phase re-derived from
uvw with double-float f32 arithmetic) must reproduce the host
planner's staging, far inside the gridder's epsilon contract
(reference accuracy setting: invert.py:179, epsilon=1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops.gridder import (
    build_assemble,
    build_invert,
    compact_plan_host_arrays,
    plan_host_arrays,
    stage_slot_vis,
    stage_slot_weights,
)
from ska_sdp_cip_tpu.ops.plan import make_plan


@pytest.fixture(scope="module")
def problem():
    uvw, _ = synthetic_uvw(4, 24, max_baseline_m=6000.0, seed=11)
    freqs = np.linspace(1.40e9, 1.46e9, 5)
    pixel_size_lm = float(np.sin(np.radians(8.0 / 3600.0)))
    plan = make_plan(uvw, freqs, 512, pixel_size_lm, epsilon=1e-4)
    rng = np.random.default_rng(5)
    shape = (len(uvw), len(freqs))
    vis = (
        rng.normal(size=shape) + 1j * rng.normal(size=shape)
    ).astype(np.complex64)
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return plan, uvw, freqs, vis, wgt


def _assembled(problem):
    plan, uvw, freqs, vis, wgt = problem
    compact = compact_plan_host_arrays(plan, uvw, freqs)
    compact_dev = {k: jnp.asarray(v) for k, v in compact.items()}
    assemble = build_assemble(plan)
    weighted = (vis * wgt).ravel()
    return plan, vis, wgt, compact_dev, assemble(
        compact_dev,
        jnp.asarray(weighted.real),
        jnp.asarray(weighted.imag),
        jnp.asarray(wgt.ravel()),
    )


def test_slot_vis_and_weights_match_host(problem):
    plan, vis, wgt, _, (re_s, im_s, wgt_s) = _assembled(problem)
    weighted = (vis * wgt).ravel()
    re_h, im_h = stage_slot_vis(plan, weighted.real, weighted.imag)
    wgt_h = stage_slot_weights(plan, wgt.ravel())
    scale = max(np.abs(re_h).max(), np.abs(im_h).max())
    assert np.abs(np.asarray(re_s) - re_h).max() / scale < 1e-5
    assert np.abs(np.asarray(im_s) - im_h).max() / scale < 1e-5
    assert np.abs(np.asarray(wgt_s) - wgt_h).max() < 1e-6


def test_compact_plan_without_packed_export(problem):
    """A plan built with export_slot_transform=False (no flip_sign /
    phase columns, native order_enc instead) must assemble to the same
    dirty image as the fully-exported plan."""
    plan_full, uvw, freqs, vis, wgt = problem
    plan = make_plan(
        uvw, freqs, 512,
        plan_full.pixel_size_lm, epsilon=1e-4,
        export_slot_transform=False,
    )
    assert plan.phase_cos is None
    compact = {
        k: jnp.asarray(v)
        for k, v in compact_plan_host_arrays(plan, uvw, freqs).items()
    }
    weighted = (vis * wgt).ravel()
    re_s, im_s = build_assemble(plan)(
        compact,
        jnp.asarray(weighted.real),
        jnp.asarray(weighted.imag),
    )
    img = np.asarray(
        build_invert(plan, slot_input=True)(compact, re_s, im_s)
    )
    # Oracle: classic staging of the fully-exported plan.
    classic = {
        k: jnp.asarray(v)
        for k, v in plan_host_arrays(
            plan_full, slot_mode=True
        ).items()
    }
    re_h, im_h = stage_slot_vis(
        plan_full, weighted.real, weighted.imag
    )
    img_classic = np.asarray(
        build_invert(plan_full, slot_input=True)(
            classic, jnp.asarray(re_h), jnp.asarray(im_h)
        )
    )
    scale = np.abs(img_classic).max()
    assert np.abs(img - img_classic).max() / scale < 1e-5


def test_slot_vis_match_host_python_planner(monkeypatch):
    """Same agreement when the plan comes from the numpy fallback
    planner (no native engine): order/flip come from ``plan.flip``
    instead of the native ``flip_sign`` export."""
    from ska_sdp_cip_tpu import native as _native

    monkeypatch.setattr(_native, "available", lambda: False)
    uvw, _ = synthetic_uvw(3, 16, max_baseline_m=5000.0, seed=21)
    freqs = np.linspace(1.40e9, 1.45e9, 3)
    pixel_size_lm = float(np.sin(np.radians(10.0 / 3600.0)))
    plan = make_plan(uvw, freqs, 256, pixel_size_lm, epsilon=1e-4)
    assert plan.flip_sign is None  # really the python planner
    compact = compact_plan_host_arrays(plan, uvw, freqs)
    rng = np.random.default_rng(4)
    n = plan.num_vis_data
    re = rng.normal(size=n).astype(np.float32)
    im = rng.normal(size=n).astype(np.float32)
    re_s, im_s = build_assemble(plan)(
        {k: jnp.asarray(v) for k, v in compact.items()},
        jnp.asarray(re),
        jnp.asarray(im),
    )
    re_h, im_h = stage_slot_vis(plan, re, im)
    scale = max(np.abs(re_h).max(), np.abs(im_h).max())
    assert np.abs(np.asarray(re_s) - re_h).max() / scale < 1e-5
    assert np.abs(np.asarray(im_s) - im_h).max() / scale < 1e-5


def test_compact_dirty_image_matches_classic(problem):
    plan, vis, wgt, arrays, (re_s, im_s, _) = _assembled(problem)
    invert = build_invert(plan, slot_input=True)
    img_compact = np.asarray(invert(arrays, re_s, im_s))

    classic = {
        k: jnp.asarray(v)
        for k, v in plan_host_arrays(plan, slot_mode=True).items()
    }
    weighted = (vis * wgt).ravel()
    re_h, im_h = stage_slot_vis(plan, weighted.real, weighted.imag)
    img_classic = np.asarray(
        invert(classic, jnp.asarray(re_h), jnp.asarray(im_h))
    )
    scale = np.abs(img_classic).max()
    assert (
        np.abs(img_compact - img_classic).max() / scale < 1e-5
    )
