"""
Every matrix product and convolution on the imaging path asks for
``Precision.HIGHEST``. On a GPU the default and ``HIGH`` settings run
float32 products in TF32 (about three decimal digits), which breaks
the epsilon=1e-4 contract; this test reads the traced programs, so it
holds on any backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.extend.core import ClosedJaxpr, Jaxpr

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops.gridder import (
    build_invert,
    build_predict,
    plan_host_arrays,
)
from ska_sdp_cip_tpu.ops.plan import make_plan

CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _precisions(jaxpr):
    """``precision`` params of every contraction, nested jaxprs too."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in CONTRACTIONS:
            found.append(eqn.params["precision"])
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                if isinstance(sub, ClosedJaxpr):
                    found.extend(_precisions(sub.jaxpr))
                elif isinstance(sub, Jaxpr):
                    found.extend(_precisions(sub))
    return found


def _assert_highest(fn, *args):
    precisions = _precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precisions, "no contraction traced"
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), set(precisions)


@pytest.fixture(scope="module")
def plan_and_arrays():
    uvw, _ = synthetic_uvw(2, 8, max_baseline_m=3000.0, seed=2)
    freqs = np.array([1.0e9, 1.05e9])
    pix = float(np.sin(np.radians(40.0 / 3600)))
    plan = make_plan(uvw, freqs, 64, pix, epsilon=1e-4)
    arrays = {k: jnp.asarray(v) for k, v in plan_host_arrays(plan).items()}
    return plan, arrays


@pytest.mark.parametrize("slots", [False, True])
def test_invert_contractions_are_highest(plan_and_arrays, slots):
    plan, arrays = plan_and_arrays
    vis = jnp.zeros(plan.num_vis, jnp.float32)
    _assert_highest(build_invert(plan, slot_input=slots), arrays, vis, vis)


@pytest.mark.parametrize("slots", [False, True])
def test_predict_contractions_are_highest(plan_and_arrays, slots):
    plan, arrays = plan_and_arrays
    image = jnp.zeros((plan.num_pixels,) * 2, jnp.float32)
    _assert_highest(build_predict(plan, slot_output=slots), arrays, image)


def test_fft_contractions_are_highest():
    from ska_sdp_cip_tpu.ops.fft import (
        fft2_split,
        fft_plan_arrays,
        make_fft_plan,
    )

    f = fft_plan_arrays(make_fft_plan(48))
    x = jnp.zeros((48, 48), jnp.float32)
    _assert_highest(lambda a, b: fft2_split(a, b, f, sign=-1), x, x)


def test_multiscale_convolution_is_highest():
    from ska_sdp_cip_tpu.models.multiscale import _conv_same

    _assert_highest(
        _conv_same, jnp.zeros((16, 16)), jnp.zeros((5, 5))
    )


def test_restore_convolution_is_highest(monkeypatch):
    from ska_sdp_cip_tpu.models.restore import restore_image

    seen = []
    original = lax.conv_general_dilated

    def spy(*args, **kwargs):
        seen.append(kwargs.get("precision"))
        return original(*args, **kwargs)

    monkeypatch.setattr(lax, "conv_general_dilated", spy)
    psf = np.zeros((32, 32), np.float32)
    psf[14:19, 14:19] = 0.5
    psf[16, 16] = 1.0
    restore_image(np.zeros((32, 32)), np.zeros((32, 32)), psf)
    assert seen == [lax.Precision.HIGHEST]
