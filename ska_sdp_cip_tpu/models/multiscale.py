"""
Multiscale CLEAN minor cycle (Cornwell 2008 style), fully on device.

Point-source CLEAN (models/clean.py) mis-models extended emission;
multiscale CLEAN decomposes the sky into components of several
characteristic sizes. Per major cycle:

* scale kernels ``k_s`` (tapered Gaussians, k_0 = delta) and the
  cross-convolved PSFs ``P_st = psf * k_s * k_t`` are built once with
  real ``lax.conv`` on float32 frames;
* the minor loop keeps one residual map per scale in a padded frame,
  picks the global (scale, pixel) peak with per-scale bias weights,
  adds ``gain * peak * k_s`` to the model, and subtracts
  ``gain * peak * P_st`` from every scale's residual at the peak
  position — a ``lax.while_loop`` with only dynamic-slice updates.

The major cycle recomputes exact residuals through the measurement
operator, so minor-cycle approximation does not accumulate.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .operators import MeasurementOperator


def scale_kernel(scale: float, radius: int) -> np.ndarray:
    """
    Normalized (unit-sum) tapered Gaussian of characteristic width
    ``scale`` pixels; scale 0 is a delta.
    """
    size = 2 * radius + 1
    kernel = np.zeros((size, size), np.float32)
    if scale <= 0:
        kernel[radius, radius] = 1.0
        return kernel
    axis = np.arange(-radius, radius + 1, dtype=np.float64)
    rr2 = np.add.outer(axis**2, axis**2)
    sigma = scale / 2.0
    kernel = np.exp(-0.5 * rr2 / sigma**2)
    return (kernel / kernel.sum()).astype(np.float32)


def _conv_same(image, kernel):
    """
    Real 2-D convolution, SAME padding (NCHW singleton frames).

    HIGHEST precision: the cross-convolved PSFs are subtracted from
    the scale residuals at every minor iteration, so their relative
    error must stay below the gridder's epsilon=1e-4 contract. The
    default precision runs float32 convolutions in TF32 on a GPU
    (~1e-3 relative), ten times that.
    """
    return lax.conv_general_dilated(
        image[None, None],
        kernel[None, None],
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )[0, 0]


@partial(
    jax.jit,
    static_argnames=("gain", "max_iter", "num_scales", "psf_patch"),
)
def _multiscale_minor(
    residual,
    psf,
    kernels,  # (S, ksize, ksize)
    biases,  # (S,)
    *,
    gain: float,
    max_iter: int,
    num_scales: int,
    psf_patch: int | None = None,
):
    """
    One multiscale minor cycle. With ``psf_patch`` (< npix) the
    Clark-style fast path runs: cross-PSF subtraction truncated to the
    central patch and per-(scale, block) maxima maintained
    incrementally — at production sizes the exact path would build
    (S, S, npix, npix) cross PSFs (6.7 GB at 10240 px) and pay
    O(S npix^2) per iteration.
    """
    if psf_patch is not None and psf_patch < residual.shape[0]:
        return _multiscale_minor_clark(
            residual,
            psf,
            kernels,
            biases,
            gain=gain,
            max_iter=max_iter,
            num_scales=num_scales,
            psf_patch=int(psf_patch),
        )
    npix = residual.shape[0]
    half = npix // 2

    # Scale-convolved residual frames (S, 2npix, 2npix)
    def pad_frame(img):
        frame = jnp.zeros((2 * npix, 2 * npix), img.dtype)
        return lax.dynamic_update_slice(frame, img, (half, half))

    res_frames = jnp.stack(
        [
            pad_frame(_conv_same(residual, kernels[s]))
            for s in range(num_scales)
        ]
    )
    # Cross PSFs P_st = psf * k_s * k_t, peak-normalized overall by
    # psf's peak (assumed ~1): (S, S, npix, npix)
    cross = jnp.stack(
        [
            jnp.stack(
                [
                    _conv_same(
                        _conv_same(psf, kernels[s]), kernels[t]
                    )
                    for t in range(num_scales)
                ]
            )
            for s in range(num_scales)
        ]
    )

    model0 = jnp.zeros((npix, npix), jnp.float32)

    def find_peak(frames):
        inner = lax.dynamic_slice(
            frames, (0, half, half), (num_scales, npix, npix)
        )
        biased = jnp.abs(inner) * biases[:, None, None]
        flat_idx = jnp.argmax(biased)
        s = flat_idx // (npix * npix)
        rem = flat_idx % (npix * npix)
        i = rem // npix
        j = rem % npix
        value = inner[s, i, j]
        return s, i, j, value, biased.reshape(-1)[flat_idx]

    def cond(state):
        _, _, it, peak_metric = state
        return jnp.logical_and(it < max_iter, peak_metric > 0.0)

    def body(state):
        frames, model, it, _ = state
        s, i, j, value, _ = find_peak(frames)
        amplitude = gain * value

        # Model gains an s-scale blob at (i, j): add amplitude * k_s
        ksize = kernels.shape[1]
        kr = ksize // 2
        pad_model = jnp.zeros(
            (npix + 2 * kr, npix + 2 * kr), jnp.float32
        )
        pad_model = lax.dynamic_update_slice(pad_model, model, (kr, kr))
        window = lax.dynamic_slice(
            pad_model, (i, j), (ksize, ksize)
        )
        pad_model = lax.dynamic_update_slice(
            pad_model, window + amplitude * kernels[s], (i, j)
        )
        model = lax.dynamic_slice(pad_model, (kr, kr), (npix, npix))

        # Every scale's residual loses amplitude * P_{s,t} at (i, j)
        def update_scale(t, frames):
            frame = frames[t]
            window = lax.dynamic_slice(frame, (i, j), (npix, npix))
            frame = lax.dynamic_update_slice(
                frame, window - amplitude * cross[s, t], (i, j)
            )
            return frames.at[t].set(frame)

        frames = lax.fori_loop(0, num_scales, update_scale, frames)
        _, _, _, _, next_metric = find_peak(frames)
        return frames, model, it + 1, next_metric

    _, _, _, metric0 = (None, None, None, find_peak(res_frames)[4])
    frames, model, _, _ = lax.while_loop(
        cond, body, (res_frames, model0, jnp.int32(0), metric0)
    )
    residual_out = lax.dynamic_slice(
        frames, (0, half, half), (1, npix, npix)
    )[0]
    return model, residual_out


def _multiscale_minor_clark(
    residual,
    psf,
    kernels,
    biases,
    *,
    gain: float,
    max_iter: int,
    num_scales: int,
    psf_patch: int,
):
    """
    Clark-style multiscale minor cycle (see :func:`_multiscale_minor`):
    per-(scale, block) biased maxima refreshed only where the truncated
    cross-PSF patches landed. All scales' frames update in ONE
    dynamic_update_slice per iteration.
    """
    from .clean import _minor_block

    npix = residual.shape[0]
    half = npix // 2
    S = num_scales
    P = psf_patch
    if P % 2:
        raise ValueError("psf_patch must be even")
    pad = P // 2
    block = _minor_block(npix, P)
    nb = npix // block
    K = P // block + 1
    ksize = kernels.shape[1]

    def pad_frame(img):
        frame = jnp.zeros((npix + P, npix + P), img.dtype)
        return lax.dynamic_update_slice(frame, img, (pad, pad))

    frames = jnp.stack(
        [
            pad_frame(_conv_same(residual, kernels[s]))
            for s in range(S)
        ]
    )

    # Cross-PSF central windows (S, S, P, P), built from a psf window
    # with a 2*ksize margin so SAME-conv edge effects stay outside the
    # kept patch. Never materializes (S, S, npix, npix).
    M = P + 2 * ksize
    m0 = (M - P) // 2
    psf_win = lax.dynamic_slice(
        psf, (half - M // 2, half - M // 2), (M, M)
    )
    cross_win = jnp.stack(
        [
            jnp.stack(
                [
                    _conv_same(
                        _conv_same(psf_win, kernels[s]), kernels[t]
                    )[m0 : m0 + P, m0 : m0 + P]
                    for t in range(S)
                ]
            )
            for s in range(S)
        ]
    )

    model0 = jnp.zeros((npix, npix), jnp.float32)
    kr = ksize // 2

    def biased_block_max(region):
        # region (S, R, R) -> (S, R/block, R/block) of biased |.|
        R = region.shape[1]
        mb = jnp.max(
            jnp.abs(
                region.reshape(S, R // block, block, R // block, block)
            ),
            axis=(2, 4),
        )
        return mb * biases[:, None, None]

    inner0 = frames[:, pad : pad + npix, pad : pad + npix]
    bm0 = biased_block_max(inner0)

    def cond(state):
        _, _, _, it, metric = state
        return jnp.logical_and(it < max_iter, metric > 0.0)

    def body(state):
        frames, model, bm, it, _ = state
        flat = jnp.argmax(bm)
        s = flat // (nb * nb)
        rem = flat % (nb * nb)
        bi = rem // nb
        bj = rem % nb
        tile = lax.dynamic_slice(
            frames,
            (s, pad + bi * block, pad + bj * block),
            (1, block, block),
        )[0]
        fine = jnp.argmax(jnp.abs(tile))
        i = bi * block + fine // block
        j = bj * block + fine % block
        value = tile.reshape(-1)[fine]
        amplitude = gain * value

        # Model gains an s-scale blob at (i, j)
        pad_model = jnp.zeros(
            (npix + 2 * kr, npix + 2 * kr), jnp.float32
        )
        pad_model = lax.dynamic_update_slice(pad_model, model, (kr, kr))
        window = lax.dynamic_slice(pad_model, (i, j), (ksize, ksize))
        pad_model = lax.dynamic_update_slice(
            pad_model, window + amplitude * kernels[s], (i, j)
        )
        model = lax.dynamic_slice(pad_model, (kr, kr), (npix, npix))

        # All scales lose amplitude * P_{s,t} patches at (i, j):
        # peak at frame (i+pad, j+pad), patch centred -> start (i, j).
        patches = jnp.take(cross_win, s, axis=0)  # (S, P, P)
        window = lax.dynamic_slice(frames, (0, i, j), (S, P, P))
        frames = lax.dynamic_update_slice(
            frames, window - amplitude * patches, (0, i, j)
        )

        # Refresh the K x K biased block maxima for every scale.
        bi0 = jnp.clip((i - P // 2) // block, 0, nb - K)
        bj0 = jnp.clip((j - P // 2) // block, 0, nb - K)
        region = lax.dynamic_slice(
            frames,
            (0, pad + bi0 * block, pad + bj0 * block),
            (S, K * block, K * block),
        )
        bm = lax.dynamic_update_slice(
            bm, biased_block_max(region), (0, bi0, bj0)
        )
        return frames, model, bm, it + 1, jnp.max(bm)

    frames, model, _, _, _ = lax.while_loop(
        cond,
        body,
        (frames, model0, bm0, jnp.int32(0), jnp.max(bm0)),
    )
    residual_out = frames[0, pad : pad + npix, pad : pad + npix]
    return model, residual_out


def multiscale_clean(
    operator: MeasurementOperator,
    vis,
    *,
    scales=(0.0, 2.0, 4.0, 8.0),
    num_major: int = 3,
    gain: float = 0.1,
    minor_iter: int = 100,
    bias_slope: float = 0.6,
    psf_patch: int | str | None = "auto",
):
    """
    Multiscale Cotton-Schwab CLEAN. Returns ``(model, residual)``.

    ``bias_slope`` down-weights large scales in peak selection
    (standard multiscale bias ``1 - slope * scale/max_scale``).
    ``psf_patch`` as in models/clean.py ("auto": Clark-truncated
    above 4096 px).
    """
    from .clean import pick_psf_patch

    if psf_patch == "auto":
        psf_patch = pick_psf_patch(operator.plan.num_pixels)
    vis = operator.stage(vis)
    psf = operator.psf()
    npix = operator.plan.num_pixels

    max_scale = max(max(scales), 1.0)
    radius = int(np.ceil(2.0 * max_scale)) + 1
    kernels = jnp.asarray(
        np.stack([scale_kernel(s, radius) for s in scales])
    )
    biases = jnp.asarray(
        np.array(
            [1.0 - bias_slope * s / max_scale for s in scales],
            np.float32,
        )
    )

    model = jnp.zeros((npix, npix), jnp.float32)
    residual = operator.dirty_image(vis)
    for _ in range(num_major):
        delta, _ = _multiscale_minor(
            residual,
            psf,
            kernels,
            biases,
            gain=gain,
            max_iter=minor_iter,
            num_scales=len(scales),
            psf_patch=psf_patch,
        )
        model = model + delta
        residual = -operator.residual_gradient(model, vis)
    return model, residual
