"""
Native (C++) planner vs numpy-fallback planner equivalence.

The fused native engine (native/cip_native.cpp:cip_slot_plan_build)
must produce the exact same block-slot layout and derived slot
columns as the pure-numpy path in ops/plan.py — same sort order, same
padding values, same flip/phase factors. Skipped when the shared
library isn't built.
"""

import numpy as np
import pytest

from ska_sdp_cip_tpu import native
from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops.gridder import plan_host_arrays
from ska_sdp_cip_tpu.ops.plan import make_plan

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


@pytest.fixture(scope="module")
def plans(monkeypatch_module=None):
    uvw, _ = synthetic_uvw(4, 24, max_baseline_m=4000.0, seed=7)
    freqs = np.linspace(1.4e9, 1.5e9, 5)
    pixel = float(np.sin(np.radians(8.0 / 3600.0)))
    kwargs = dict(epsilon=1e-4)
    nat = make_plan(uvw, freqs, 256, pixel, **kwargs)
    # Force the numpy fallback by pretending the library is absent.
    orig = native.available
    native.available = lambda: False
    try:
        ref = make_plan(uvw, freqs, 256, pixel, **kwargs)
    finally:
        native.available = orig
    return nat, ref


SLOT_COLUMNS = ["order", "x0", "y0", "fx", "fy", "ws", "flip"]
BLOCK_COLUMNS = ["block_start", "block_len", "block_ox", "block_oy"]


def test_slot_layout_matches(plans):
    nat, ref = plans
    assert nat.num_blocks == ref.num_blocks
    assert nat.num_vis == ref.num_vis
    for name in SLOT_COLUMNS:
        np.testing.assert_array_equal(
            getattr(nat, name), getattr(ref, name), err_msg=name
        )
    for name in BLOCK_COLUMNS:
        np.testing.assert_array_equal(
            getattr(nat, name), getattr(ref, name), err_msg=name
        )


def test_derived_columns_match_host_arrays(plans):
    """Native-exported flip_sign/phase == numpy-built ones."""
    nat, ref = plans
    assert nat.flip_sign is not None
    assert ref.flip_sign is None
    a = plan_host_arrays(nat)
    b = plan_host_arrays(ref)
    np.testing.assert_array_equal(a["flip_sign"], b["flip_sign"])
    np.testing.assert_allclose(
        a["phase_cos"], b["phase_cos"], atol=1e-6
    )
    np.testing.assert_allclose(
        a["phase_sin"], b["phase_sin"], atol=1e-6
    )
