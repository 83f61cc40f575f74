"""
2-D FFT as real matrix products on split (re, im) float32 data
(four-step / Bailey FFT).

For N = N1 * N2 the four-step decomposition

    X[k1 + N1 k2] = sum_{n2} W_N^{n2 k1} W_{N2}^{n2 k2}
                    [ sum_{n1} x[n1 N2 + n2] W_{N1}^{n1 k1} ]

is two dense (N1, N1) / (N2, N2) matmul stages plus a twiddle —
O(N (N1 + N2)) work in large matrix products, with the centring shifts
and the image crop folded into the factor matrices.

Plans hold the cos/sin DFT factors and twiddles (f32); ``fft2_split``
applies both axes. Every stage product runs at ``Precision.HIGHEST``
(true float32): on a GPU the default and ``HIGH`` settings run float32
products in TF32, which keeps about three decimal digits — too few for
the gridder's epsilon=1e-4 contract.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

#: Matmul precision of the DFT stages (see the module docstring).
PRECISION = jax.lax.Precision.HIGHEST


def _near_square_factors(n: int) -> tuple[int, int]:
    """Factor n = n1 * n2 with n1 <= n2 as close to sqrt(n) as possible."""
    best = (1, n)
    for n1 in range(1, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            best = (n1, n // n1)
    return best


@dataclass(frozen=True)
class FFTPlan:
    """Four-step DFT factors for one axis length (host numpy, f32)."""

    n: int
    n1: int
    n2: int
    d1_cos: np.ndarray
    d1_sin: np.ndarray
    d2_cos: np.ndarray
    d2_sin: np.ndarray
    tw_cos: np.ndarray
    tw_sin: np.ndarray


def make_fft_plan(n: int, *, shifted: bool = False) -> FFTPlan:
    """
    Build the factor matrices for a length-``n`` DFT with the *negative*
    exponent convention (numpy's forward fft). The inverse transform
    reuses the same plan with ``sign=+1`` (factors are conjugated by
    flipping the sine terms at apply time).

    With ``shifted=True`` the factors implement the *centred* transform
    ``fftshift o DFT o ifftshift`` (even n), i.e.
    ``M[k, j] = c * (-1)^(k+j) * W^(kj)`` with the constant
    ``c = exp(sign * i pi n / 2)`` — the shift permutations the gridder
    would otherwise pay as full-array roll passes are free inside the
    factor matrices. The constant is folded as a rotation of the D2
    factor, which works for both transform signs because conjugating
    (cos, sin) -> (cos, -sin) conjugates ``c`` along with the rest.
    """
    n1, n2 = _near_square_factors(n)

    j1 = np.arange(n1)
    j2 = np.arange(n2)
    # D1[k1, j1] = exp(-2 pi i j1 k1 / n1)   (applied from the left)
    a1 = 2.0 * np.pi * np.outer(j1, j1) / n1
    # D2[j2, k2] = exp(-2 pi i j2 k2 / n2)   (applied from the right)
    a2 = 2.0 * np.pi * np.outer(j2, j2) / n2
    # twiddle[k1, j2] = exp(-2 pi i j2 k1 / n)
    at = 2.0 * np.pi * np.outer(j1, j2) / n

    d1 = np.exp(-1j * a1)
    d2 = np.exp(-1j * a2)
    tw = np.exp(-1j * at)

    if shifted:
        if n % 2:
            raise ValueError("shifted transform requires even n")
        # (-1)^j with j = j1 * n2 + j2 and (-1)^k with k = k1 + n1 * k2:
        # fold the j1/k1 parts into D1/twiddle, the j2/k2 parts plus the
        # constant exp(-i pi n / 2) into D2.
        sign_j1 = (-1.0) ** (j1 * n2)
        sign_k1 = (-1.0) ** j1  # k1 ranges over arange(n1)
        sign_j2 = (-1.0) ** j2
        sign_k2 = (-1.0) ** (n1 * j2)  # k2 ranges over arange(n2)
        constant = np.exp(-1j * np.pi * (n / 2.0))
        d1 = d1 * sign_j1[None, :]
        tw = tw * sign_k1[:, None]
        d2 = d2 * sign_j2[:, None] * sign_k2[None, :] * constant

    return FFTPlan(
        n=n,
        n1=n1,
        n2=n2,
        d1_cos=np.real(d1).astype(np.float32),
        d1_sin=(-np.imag(d1)).astype(np.float32),
        d2_cos=np.real(d2).astype(np.float32),
        d2_sin=(-np.imag(d2)).astype(np.float32),
        tw_cos=np.real(tw).astype(np.float32),
        tw_sin=(-np.imag(tw)).astype(np.float32),
    )


def fft_plan_arrays(plan: FFTPlan, prefix: str = "fft") -> dict:
    """Plan factors as a dict of device-ready arrays."""
    return {
        f"{prefix}_d1_cos": jnp.asarray(plan.d1_cos),
        f"{prefix}_d1_sin": jnp.asarray(plan.d1_sin),
        f"{prefix}_d2_cos": jnp.asarray(plan.d2_cos),
        f"{prefix}_d2_sin": jnp.asarray(plan.d2_sin),
        f"{prefix}_tw_cos": jnp.asarray(plan.tw_cos),
        f"{prefix}_tw_sin": jnp.asarray(plan.tw_sin),
    }


def _factors(f, prefix, sign):
    d1_cos = f[f"{prefix}_d1_cos"]
    d1_sin = f[f"{prefix}_d1_sin"]
    d2_cos = f[f"{prefix}_d2_cos"]
    d2_sin = f[f"{prefix}_d2_sin"]
    tw_cos = f[f"{prefix}_tw_cos"]
    tw_sin = f[f"{prefix}_tw_sin"]
    # Factors store (cos a, sin a) of the -i convention matrices;
    # D(sign) = cos + i * sign * sin conjugates cleanly for sign=+1.
    return d1_cos, d1_sin, d2_cos, d2_sin, tw_cos, tw_sin, float(sign)


def _stage1_block(d1_cos, d1_sin, s):
    """
    Real 2x2-block form of the stage-1 complex factor: ``[[C, -sS],
    [sS, C]]`` applied to ``[xr; xi]`` stacked along the contracted
    axis yields ``[yr; yi]`` in ONE dot. The naive four-real-matmul
    form materializes four full-grid partials plus a combine pass —
    about twice the memory traffic of this form.
    """
    top = jnp.concatenate([d1_cos, -s * d1_sin], axis=1)
    bot = jnp.concatenate([s * d1_sin, d1_cos], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def _stage2_block(d2_cos, d2_sin, s):
    """
    Real 2x2-block form of the stage-2 factor: ``[[C, sS], [-sS, C]]``
    contracted against ``[zr, zi]`` stacked along n yields
    ``[out_r, out_i]`` stacked along the output axis in ONE dot.
    """
    left = jnp.concatenate([d2_cos, s * d2_sin], axis=1)
    right = jnp.concatenate([-s * d2_sin, d2_cos], axis=1)
    return jnp.concatenate([left, right], axis=0)


def fft_last_axis(
    re,
    im,
    f,
    *,
    sign: int,
    prefix: str = "fft",
    in_crop: tuple | None = None,
    out_crop: tuple | None = None,
):
    """
    DFT along the last axis of (..., n) split arrays. ``sign=-1`` is
    the forward (numpy fft) transform, ``sign=+1`` the unnormalized
    inverse (scale by 1/n yourself if needed). ``f`` is the dict from
    :func:`fft_plan_arrays`. The four-step output reorder rides inside
    the stage-2 einsum (no explicit transpose pass), and the complex
    arithmetic rides inside both dots as real 2x2-block factor
    matrices (:func:`_stage1_block`), so no separate combine pass ever
    touches the full-size intermediates.

    ``in_crop=(start, size)``: the inputs hold only logical columns
    ``[start, start + size)`` (rest zero) — stage 1 is pruned to the
    covering j1 rows. ``out_crop=(start, size)``: only those output
    columns are computed — stage 2 is pruned to the covering k2 range.
    Both prune roughly half the FFT cost for the gridder's 2x-padded
    grids (invert crops to the image; predict pads from it).
    """
    d1_cos, d1_sin, d2_cos, d2_sin, tw_cos, tw_sin, s = _factors(
        f, prefix, sign
    )
    n1, n2 = d1_cos.shape[0], d2_cos.shape[0]
    n = n1 * n2

    batch = re.shape[:-1]
    if in_crop is not None:
        c0, size = in_crop
        j1a, j1b = c0 // n2, -(-(c0 + size) // n2)
        width = (j1b - j1a) * n2
        pad_lo = c0 - j1a * n2
        shape = batch + (width,)
        xr = (
            jnp.zeros(shape, re.dtype)
            .at[..., pad_lo : pad_lo + size]
            .set(re)
            .reshape((-1, j1b - j1a, n2))
        )
        xi = (
            jnp.zeros(shape, im.dtype)
            .at[..., pad_lo : pad_lo + size]
            .set(im)
            .reshape((-1, j1b - j1a, n2))
        )
        d1_cos = d1_cos[:, j1a:j1b]
        d1_sin = d1_sin[:, j1a:j1b]
    else:
        xr = re.reshape((-1, n1, n2))
        xi = im.reshape((-1, n1, n2))

    # Stage 1: [yr; yi][b, 2n1, n2] = M1 [xr; xi] (one block dot)
    x2 = jnp.concatenate([xr, xi], axis=1)
    y = jnp.einsum(
        "kj,bjn->bkn", _stage1_block(d1_cos, d1_sin, s), x2,
        precision=PRECISION,
    )
    yr = y[:, :n1, :]
    yi = y[:, n1:, :]

    # Twiddle T(sign)[k1, n2], written straight into the stage-2
    # stacked layout (b, n1, 2 n2) — one fused elementwise pass.
    tr = tw_cos[None, :, :]
    ti = s * tw_sin[None, :, :]
    z2 = jnp.concatenate(
        [yr * tr - yi * ti, yr * ti + yi * tr], axis=-1
    )

    if out_crop is not None:
        c0, size = out_crop
        k2a, k2b = c0 // n1, -(-(c0 + size) // n1)
        d2_cos = d2_cos[:, k2a:k2b]
        d2_sin = d2_sin[:, k2a:k2b]
        trim = (c0 - k2a * n1, size)
        n_out = (k2b - k2a) * n1
    else:
        trim = None
        n_out = n
    q = d2_cos.shape[1]

    # Stage 2 with fused reorder: out[b, 2q, k1] = z2 D2block;
    # flattening (k2, k1) row-major yields index k1 + n1 * k2 = k.
    out = jnp.einsum(
        "bkn,nq->bqk", z2, _stage2_block(d2_cos, d2_sin, s),
        precision=PRECISION,
    )
    outr = out[:, :q, :].reshape(batch + (n_out,))
    outi = out[:, q:, :].reshape(batch + (n_out,))
    if trim is not None:
        outr = outr[..., trim[0] : trim[0] + trim[1]]
        outi = outi[..., trim[0] : trim[0] + trim[1]]
    return outr, outi


def fft_first_axis(
    re,
    im,
    f,
    *,
    sign: int,
    prefix: str = "fft",
    in_crop: tuple | None = None,
    out_crop: tuple | None = None,
):
    """
    DFT along the FIRST axis of (n, m) split arrays, transpose-free:
    both four-step stages contract the leading axis via einsum with
    real 2x2-block complex factors (see :func:`fft_last_axis`) and the
    output reorder is fused into stage 2. ``in_crop``/``out_crop`` as
    in :func:`fft_last_axis`, applied to the first axis.
    """
    d1_cos, d1_sin, d2_cos, d2_sin, tw_cos, tw_sin, s = _factors(
        f, prefix, sign
    )
    n1, n2 = d1_cos.shape[0], d2_cos.shape[0]
    n = n1 * n2
    m = re.shape[-1]

    if in_crop is not None:
        c0, size = in_crop
        j1a, j1b = c0 // n2, -(-(c0 + size) // n2)
        width = (j1b - j1a) * n2
        pad_lo = c0 - j1a * n2
        xr = (
            jnp.zeros((width, m), re.dtype)
            .at[pad_lo : pad_lo + size, :]
            .set(re)
            .reshape((j1b - j1a, n2, m))
        )
        xi = (
            jnp.zeros((width, m), im.dtype)
            .at[pad_lo : pad_lo + size, :]
            .set(im)
            .reshape((j1b - j1a, n2, m))
        )
        d1_cos = d1_cos[:, j1a:j1b]
        d1_sin = d1_sin[:, j1a:j1b]
    else:
        xr = re.reshape((n1, n2, m))
        xi = im.reshape((n1, n2, m))

    # Stage 1: [yr; yi][2n1, n2, m] = M1 [xr; xi] (one block dot)
    x2 = jnp.concatenate([xr, xi], axis=0)
    y = jnp.einsum(
        "kj,jnm->knm", _stage1_block(d1_cos, d1_sin, s), x2,
        precision=PRECISION,
    )
    yr = y[:n1]
    yi = y[n1:]

    # Twiddle, written into the stage-2 stacked layout (n1, 2n2, m).
    tr = tw_cos[:, :, None]
    ti = s * tw_sin[:, :, None]
    z2 = jnp.concatenate(
        [yr * tr - yi * ti, yr * ti + yi * tr], axis=1
    )

    if out_crop is not None:
        c0, size = out_crop
        k2a, k2b = c0 // n1, -(-(c0 + size) // n1)
        d2_cos = d2_cos[:, k2a:k2b]
        d2_sin = d2_sin[:, k2a:k2b]
        trim = (c0 - k2a * n1, size)
        n_out = (k2b - k2a) * n1
    else:
        trim = None
        n_out = n
    q = d2_cos.shape[1]

    # Stage 2 with fused reorder: out[2q, k1, m] = z2 D2block;
    # flattening (k2, k1) row-major yields index k.
    out = jnp.einsum(
        "knm,nq->qkm", z2, _stage2_block(d2_cos, d2_sin, s),
        precision=PRECISION,
    )
    outr = out[:q].reshape((n_out, m))
    outi = out[q:].reshape((n_out, m))
    if trim is not None:
        outr = outr[trim[0] : trim[0] + trim[1], :]
        outi = outi[trim[0] : trim[0] + trim[1], :]
    return outr, outi


def fft2_split(re, im, f, *, sign: int, prefix: str = "fft"):
    """
    2-D DFT of split (re, im) square arrays: one last-axis pass and one
    first-axis pass, no explicit transposes. Unnormalized in both
    directions. With a ``shifted=True`` plan this computes the centred
    transform (fftshift o F o ifftshift) on both axes.
    """
    re, im = fft_last_axis(re, im, f, sign=sign, prefix=prefix)
    return fft_first_axis(re, im, f, sign=sign, prefix=prefix)
