"""
The gridder (the one XLA path) against the float64 DFT oracle and the
invert/predict adjoint identity, over the plan configurations
production runs reach: block sizes 128-1024, oversampling 1.5 and 2.0,
w-stacking on and off, a grid many 128-cell y windows wide, a plan with
many w-planes, and multi-bin blocks. Accuracy contract: epsilon=1e-4
(reference: src/ska_sdp_cip/invert.py:179).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops.dft import dirty_pixels_dft
from ska_sdp_cip_tpu.ops.gridder import (
    build_invert,
    build_predict,
    plan_device_arrays,
    split_complex,
)
from ska_sdp_cip_tpu.ops.plan import make_plan

#: name -> (make_plan overrides, num_pixels, pixel size in arcsec)
CONFIGS = {
    "block128": (dict(block=128), 96, 40.0),
    "block256": (dict(block=256), 96, 40.0),
    "block512": (dict(block=512), 96, 40.0),
    "block1024": (dict(block=1024), 96, 40.0),
    "sigma1.5": (dict(sigma=1.5), 96, 40.0),
    "sigma2.0": (dict(sigma=2.0), 96, 40.0),
    "no_wstacking": (dict(do_wstacking=False), 96, 40.0),
    "wide_grid": (dict(), 320, 12.0),
    "many_planes": (dict(), 128, 300.0),
    "bin_group3": (dict(bin_group=3, block=256), 128, 300.0),
}

_CACHE = {}


def _problem():
    rng = np.random.default_rng(23)
    uvw, _ = synthetic_uvw(4, 12, max_baseline_m=5000.0, seed=31)
    freqs = np.array([1.0e9, 1.07e9, 1.12e9])
    shape = (len(uvw), len(freqs))
    vis = (
        rng.normal(size=shape) + 1j * rng.normal(size=shape)
    ).astype(np.complex64)
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis * wgt


def _built(name):
    """Plan, staged arrays and jitted operators, shared by the checks."""
    if name not in _CACHE:
        overrides, npix, asec = CONFIGS[name]
        uvw, freqs, weighted = _problem()
        pix = float(np.sin(np.radians(asec / 3600.0)))
        plan = make_plan(uvw, freqs, npix, pix, epsilon=1e-4, **overrides)
        _CACHE[name] = (
            plan,
            plan_device_arrays(plan),
            build_invert(plan),
            build_predict(plan),
            uvw,
            freqs,
            weighted,
            pix,
        )
    return _CACHE[name]


def _padded(plan, weighted):
    re, im = split_complex(weighted.ravel())
    out = []
    for part in (re, im):
        padded = np.zeros(plan.num_vis, np.float32)
        padded[: len(part)] = part
        out.append(jnp.asarray(padded))
    return out


def test_configs_exercise_their_feature():
    assert _built("block1024")[0].block == 1024
    assert _built("sigma1.5")[0].sigma == 1.5
    assert _built("sigma1.5")[0].support > _built("sigma2.0")[0].support
    assert not _built("no_wstacking")[0].wstacking
    assert _built("no_wstacking")[0].nplanes == 1
    assert _built("wide_grid")[0].nalloc_y // 128 >= 6
    assert _built("many_planes")[0].nplanes >= 20
    # Multi-bin blocks: some block's plane window exceeds the support.
    plan = _built("bin_group3")[0]
    table = plan.active_table
    assert np.bincount(table[table >= 0]).max() > plan.support


@pytest.mark.parametrize("check", ["dft", "adjoint"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_gridder(name, check):
    plan, arrays, invert, predict, uvw, freqs, weighted, pix = _built(name)
    re, im = _padded(plan, weighted)
    dirty = np.asarray(invert(arrays, re, im))
    if check == "dft":
        rng = np.random.default_rng(1)
        npix = plan.num_pixels
        pixels = np.concatenate(
            [
                [np.unravel_index(np.argmax(np.abs(dirty)), dirty.shape)],
                [[0, 0], [npix - 1, npix - 1]],
                rng.integers(0, npix, size=(40, 2)),
            ]
        )
        reference = dirty_pixels_dft(
            uvw, freqs, weighted, pixels, npix, pix,
            apply_w=plan.wstacking,
        )
        ours = dirty[pixels[:, 0], pixels[:, 1]]
        error = np.max(np.abs(ours - reference)) / np.max(np.abs(reference))
        assert error < 1e-4
    else:
        image = np.random.default_rng(7).normal(size=dirty.shape)
        image = image.astype(np.float32)
        out_re, out_im = predict(arrays, jnp.asarray(image))
        model = np.asarray(out_re) + 1j * np.asarray(out_im)
        lhs = float(np.dot(image.ravel().astype(np.float64), dirty.ravel()))
        rhs = float(np.real(np.vdot(model, weighted.ravel())))
        assert lhs == pytest.approx(rhs, rel=1e-4)
