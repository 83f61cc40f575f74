"""
Plan layout rules that the gridder relies on: block-size and patch
defaults with their overrides, and the alloc frame holding every block
patch plus the fold's wrap margin.
"""

import numpy as np
import pytest

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops.plan import make_plan


def test_auto_block_thresholds():
    from ska_sdp_cip_tpu.ops.plan import auto_block

    assert auto_block(10_000) == 128
    assert auto_block(2_000_000) == 256
    assert auto_block(4_500_000) == 512
    assert auto_block(6_000_000) == 1024


def test_patch_height_env_override(monkeypatch):
    """CIP_PATCH_X reaches the plan; clamps below the support need."""
    uvw, _ = synthetic_uvw(2, 8, max_baseline_m=2000.0, seed=9)
    freqs = np.array([1.0e9])
    pix = float(np.sin(np.radians(40.0 / 3600)))

    monkeypatch.setenv("CIP_PATCH_X", "64")
    plan = make_plan(uvw, freqs, 64, pix, epsilon=1e-4)
    assert plan.patch_x == 64

    monkeypatch.setenv("CIP_PATCH_X", "16")
    plan = make_plan(uvw, freqs, 64, pix, epsilon=1e-5)
    # epsilon=1e-5 needs support 7-10; 16 rows cannot hold the
    # footprint plus one 8-row tile column, so the plan clamps up.
    assert plan.patch_x >= plan.support + 8

    monkeypatch.setenv("CIP_PATCH_X", "20")
    with pytest.raises(ValueError, match="multiple of 8"):
        make_plan(uvw, freqs, 64, pix)


@pytest.mark.parametrize(
    "npix, asec, sigma",
    [(64, 40.0, 2.0), (96, 40.0, 1.5), (320, 12.0, 2.0), (128, 300.0, 1.5)],
)
def test_alloc_holds_every_patch_and_the_wrap_margin(npix, asec, sigma):
    uvw, _ = synthetic_uvw(4, 12, max_baseline_m=5000.0, seed=31)
    freqs = np.array([1.0e9, 1.07e9, 1.12e9])
    pix = float(np.sin(np.radians(asec / 3600)))
    plan = make_plan(uvw, freqs, npix, pix, epsilon=1e-4, sigma=sigma)
    real = plan.block_len > 0
    assert (plan.block_ox[real] % 8 == 0).all()
    assert (plan.block_oy[real] % 128 == 0).all()
    assert plan.block_ox.max() + plan.patch_x <= plan.nalloc_x
    assert plan.block_oy.max() + plan.patch_y <= plan.nalloc_y
    assert plan.nalloc_y % 128 == 0
    margin = plan.ngrid + 2 * plan.support
    assert plan.nalloc_x >= margin and plan.nalloc_y >= margin
    # Every real slot's x footprint lies inside its block's patch; a y
    # footprint may straddle a 128-cell window, and each of its two
    # slots then covers the part inside its own window.
    slots = np.flatnonzero(plan.order < plan.num_vis_data)
    block = slots // plan.block
    dx = plan.x0[slots] - plan.block_ox[block]
    dy = plan.y0[slots] - plan.block_oy[block]
    assert dx.min() >= 0 and (dx + plan.support).max() <= plan.patch_x
    assert (dy + plan.support > 0).all() and (dy < plan.patch_y).all()
