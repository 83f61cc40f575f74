"""
Matmul four-step FFT against numpy's FFT: both axis passes, both
signs, shifted factors, and the in/out crop pruning — the complex-free
transform every invert/predict rides on (ops/fft.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_cip_tpu.ops.fft import (
    fft2_split,
    fft_first_axis,
    fft_last_axis,
    fft_plan_arrays,
    make_fft_plan,
)

N = 160  # = 10 * 16, exercises unequal four-step factors


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    x = (
        rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    ).astype(np.complex64)
    return x


def _tol(ref):
    return 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("sign", [-1, +1])
def test_fft2_matches_numpy(data, sign):
    f = fft_plan_arrays(make_fft_plan(N))
    re, im = fft2_split(
        jnp.asarray(data.real), jnp.asarray(data.imag), f, sign=sign
    )
    got = np.asarray(re) + 1j * np.asarray(im)
    ref = np.fft.fft2(data) if sign == -1 else np.fft.ifft2(data) * N**2
    np.testing.assert_allclose(got, ref, atol=_tol(ref))


@pytest.mark.parametrize("sign", [-1, +1])
def test_shifted_fft2_matches_numpy(data, sign):
    f = fft_plan_arrays(make_fft_plan(N, shifted=True))
    re, im = fft2_split(
        jnp.asarray(data.real), jnp.asarray(data.imag), f, sign=sign
    )
    got = np.asarray(re) + 1j * np.asarray(im)
    shifted_in = np.fft.ifftshift(data)
    ref = np.fft.fftshift(
        np.fft.fft2(shifted_in)
        if sign == -1
        else np.fft.ifft2(shifted_in) * N**2
    )
    np.testing.assert_allclose(got, ref, atol=_tol(ref))


def test_out_crop_matches_full(data):
    f = fft_plan_arrays(make_fft_plan(N, shifted=True))
    c0, size = (N - N // 2) // 2, N // 2
    full_re, full_im = fft_last_axis(
        jnp.asarray(data.real), jnp.asarray(data.imag), f, sign=+1
    )
    crop_re, crop_im = fft_last_axis(
        jnp.asarray(data.real),
        jnp.asarray(data.imag),
        f,
        sign=+1,
        out_crop=(c0, size),
    )
    np.testing.assert_allclose(
        np.asarray(crop_re),
        np.asarray(full_re)[:, c0 : c0 + size],
        atol=_tol(np.asarray(full_re)),
    )
    np.testing.assert_allclose(
        np.asarray(crop_im),
        np.asarray(full_im)[:, c0 : c0 + size],
        atol=_tol(np.asarray(full_im)),
    )


def test_in_crop_matches_zero_padded(data):
    f = fft_plan_arrays(make_fft_plan(N, shifted=True))
    c0, size = (N - N // 2) // 2, N // 2
    padded = np.zeros((N, N), np.complex64)
    padded[c0 : c0 + size] = data[c0 : c0 + size]
    full_re, full_im = fft_first_axis(
        jnp.asarray(padded.real), jnp.asarray(padded.imag), f, sign=-1
    )
    crop_re, crop_im = fft_first_axis(
        jnp.asarray(padded.real[c0 : c0 + size]),
        jnp.asarray(padded.imag[c0 : c0 + size]),
        f,
        sign=-1,
        in_crop=(c0, size),
    )
    np.testing.assert_allclose(
        np.asarray(crop_re), np.asarray(full_re), atol=_tol(full_re)
    )
    np.testing.assert_allclose(
        np.asarray(crop_im), np.asarray(full_im), atol=_tol(full_im)
    )


#: Even 7-smooth lengths (the grid sizes ``next_even_grid_size`` picks),
#: with square, unequal and prime-heavy four-step factorizations.
SMOOTH_LENGTHS = [6, 14, 30, 42, 64, 70, 98, 120, 126, 210]


def _axis_reference(x, axis, sign):
    """Unnormalized, centred (fftshift o DFT o ifftshift) numpy DFT."""
    shifted = np.fft.ifftshift(x, axes=axis)
    out = (
        np.fft.fft(shifted, axis=axis)
        if sign == -1
        else np.fft.ifft(shifted, axis=axis) * x.shape[axis]
    )
    return np.fft.fftshift(out, axes=axis)


@pytest.mark.parametrize("crop", ["none", "in", "out"])
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("n", SMOOTH_LENGTHS)
def test_axis_passes_match_numpy(n, sign, crop):
    """Both axis passes of the centred four-step DFT against numpy in
    float64, for 7-smooth lengths, both signs, and input/output crops
    (the invert crops its output to the image, predict pads its input
    from it)."""
    rng = np.random.default_rng(n)
    m = 5
    x = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
    f = fft_plan_arrays(make_fft_plan(n, shifted=True))
    c0, size = n // 4, n // 2
    kwargs = {}
    if crop == "in":
        x[:, :c0] = 0.0
        x[:, c0 + size :] = 0.0
        kwargs["in_crop"] = (c0, size)
        last_in, first_in = x[:, c0 : c0 + size], x.T[c0 : c0 + size]
    else:
        last_in, first_in = x, x.T
        if crop == "out":
            kwargs["out_crop"] = (c0, size)
    ref_last = _axis_reference(x, -1, sign)
    ref_first = _axis_reference(x.T, 0, sign)
    if crop == "out":
        ref_last = ref_last[:, c0 : c0 + size]
        ref_first = ref_first[c0 : c0 + size]

    for fn, inp, ref in (
        (fft_last_axis, last_in, ref_last),
        (fft_first_axis, first_in, ref_first),
    ):
        re, im = fn(
            jnp.asarray(inp.real, jnp.float32),
            jnp.asarray(inp.imag, jnp.float32),
            f,
            sign=sign,
            **kwargs,
        )
        got = np.asarray(re) + 1j * np.asarray(im)
        np.testing.assert_allclose(got, ref, atol=_tol(ref))
