"""
W-bin-grouped blocks (ska_sdp_cip_tpu/ops/plan.py:auto_bin_group):
blocks may span ``bin_group`` adjacent w-data-bins, cutting the
per-visibility kernel block-step count to
``(support + g - 1) / (g * support)`` while the ES w-factor zeroes
the extra plane visits exactly. These tests pin the plan invariants,
the native/numpy agreement, and the end-to-end invert equivalence.
"""

import numpy as np
import pytest

from ska_sdp_cip_tpu import native
from ska_sdp_cip_tpu.ops.plan import (
    auto_bin_group,
    auto_block_and_group,
    make_plan,
)

NPIX, PIX = 512, 2.5e-5  # wide enough FOV for several w planes


def _case(seed=0, nrow=6000, nchan=4):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-3000, 3000, (nrow, 3))
    freqs = np.linspace(1.2e9, 1.3e9, nchan)
    return uvw, freqs


def _plan(uvw, freqs, bin_group, force_numpy=False, **kw):
    if force_numpy:
        orig = native.available
        native.available = lambda: False
        try:
            return make_plan(
                uvw, freqs, NPIX, PIX, epsilon=1e-4,
                bin_group=bin_group, **kw,
            )
        finally:
            native.available = orig
    return make_plan(
        uvw, freqs, NPIX, PIX, epsilon=1e-4, bin_group=bin_group, **kw
    )


@pytest.mark.parametrize("bin_group", [2, 3])
def test_grouped_plan_native_matches_numpy(bin_group):
    uvw, freqs = _case()
    if not native.available():
        pytest.skip("native engine not built")
    pn = _plan(uvw, freqs, bin_group)
    pp = _plan(uvw, freqs, bin_group, force_numpy=True)
    assert pn.num_blocks == pp.num_blocks
    for f in ("order", "x0", "y0", "block_len", "block_ox", "block_oy"):
        assert np.array_equal(getattr(pn, f), getattr(pp, f)), f
    assert np.array_equal(pn.active_table, pp.active_table)


def test_grouping_cuts_block_steps():
    uvw, freqs = _case()
    p1 = _plan(uvw, freqs, 1, block=128)
    p2 = _plan(uvw, freqs, 2, block=256)
    assert p2.nplanes == p1.nplanes > 1
    # Block steps of the gridding scan: one per (plane, active block).
    s1 = int((p1.active_table >= 0).sum())
    s2 = int((p2.active_table >= 0).sum())
    # support 6, g=2: per-vis plane window grows 6 -> <= 7 while
    # blocks double, so steps must drop well below s1 (7/12 + fill).
    assert s2 < 0.9 * s1, (s1, s2)


def test_grouped_block_windows_stay_tight():
    """Per-block [bin_lo, bin_hi] is exact, not the group envelope:
    each block's plane window may exceed ``support`` planes by at
    most ``bin_group - 1``, and every sample's own support window is
    contained in its block's window."""
    uvw, freqs = _case(seed=3)
    g = 3
    plan = _plan(uvw, freqs, g)
    support = plan.support
    visits = (plan.active_table >= 0).sum(axis=0)
    counts = np.bincount(
        plan.active_table[plan.active_table >= 0].ravel(),
        minlength=plan.num_blocks,
    )
    real = plan.block_len > 0
    assert (counts[real] <= support + g - 1).all()
    assert (counts[real] >= 1).all()
    del visits
    # Every real sample's w bin lies inside its block's plane window:
    # plane window [lo, hi] covers bins [lo, hi - support + 1].
    wbin = np.floor((plan.ws - (plan.w0 + (support / 2.0 - 1.0) * plan.dw)) / plan.dw)
    slot_block = np.arange(plan.num_vis) // plan.block
    lane = np.arange(plan.num_vis) % plan.block
    valid = lane < plan.block_len[slot_block]
    table = plan.active_table
    lo = np.full(plan.num_blocks, plan.nplanes, np.int64)
    hi = np.full(plan.num_blocks, -1, np.int64)
    for p in range(plan.nplanes):
        row = table[p][table[p] >= 0]
        lo[row] = np.minimum(lo[row], p)
        hi[row] = np.maximum(hi[row], p)
    b = slot_block[valid]
    q = np.clip(wbin[valid], 0, None)
    assert (q >= lo[b]).all()
    assert (q + support - 1 <= hi[b] + 1e-9).all()


def test_grouped_invert_matches_ungrouped():
    from ska_sdp_cip_tpu.wgridder import ms2dirty

    uvw, freqs = _case(seed=7, nrow=3000, nchan=2)
    rng = np.random.default_rng(11)
    n = 3000 * 2
    vis = (
        rng.normal(size=(3000, 2)) + 1j * rng.normal(size=(3000, 2))
    ).astype(np.complex64)
    wgt = rng.uniform(0.2, 1.0, (3000, 2)).astype(np.float32)
    del n

    import os

    def dirty(group):
        os.environ["CIP_WBIN_GROUP"] = str(group)
        try:
            return ms2dirty(
                uvw, freqs, vis, wgt, NPIX, NPIX, PIX, PIX,
                epsilon=1e-4, do_wstacking=True,
            )
        finally:
            os.environ.pop("CIP_WBIN_GROUP", None)

    d1 = dirty(1)
    d2 = dirty(2)
    scale = np.abs(d1).max()
    assert np.abs(d2 - d1).max() / scale < 2e-5


def test_auto_block_and_group_consistency(monkeypatch):
    monkeypatch.delenv("CIP_BLOCK", raising=False)
    monkeypatch.delenv("CIP_WBIN_GROUP", raising=False)
    # Small workloads stay ungrouped; dense ones group at the SAME
    # block size (the grouping is a fill gain, not longer steps).
    assert auto_bin_group(100_000) == 1
    assert auto_block_and_group(6_000_000) == (1024, 4)
    monkeypatch.setenv("CIP_WBIN_GROUP", "1")
    assert auto_block_and_group(6_000_000) == (1024, 1)
    monkeypatch.setenv("CIP_WBIN_GROUP", "0")
    with pytest.raises(ValueError):
        auto_bin_group(1)
