"""
Distributed major-cycle deconvolution (BASELINE.json config 5:
multi-host partitioned invert + major-cycle first-order deconvolution).

One SPMD step per major cycle, fully on device: every shard predicts
its model visibilities, forms the weighted residual, grids it, the
partial gradients are ``psum``-reduced over the mesh, and the Hogbom
minor cycle runs on the (replicated) reduced residual — so the model
update is identical on every device and no host round-trips happen
inside a cycle. The host loop only sequences cycles and handles
checkpointing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..io.visibility_dataset import VisibilityReader
from ..models.clean import hogbom_clean, pick_psf_patch
from ..ops.gridder import build_invert, build_predict
from .sharded_invert import (
    _is_replicated,
    stage_sharded_inputs,
)


def sharded_major_cycle_clean(
    reader: VisibilityReader,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    mesh: Mesh | None = None,
    row_chunks: int | None = None,
    freq_chunks: int | None = None,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    weighting: str = "natural",
    robust: float = 0.0,
    num_major: int = 3,
    gain: float = 0.1,
    minor_iter: int = 100,
    recorder=None,
    algorithm: str = "hogbom",
    scales=(0.0, 2.0, 4.0, 8.0),
    bias_slope: float = 0.6,
    lam_factor: float = 1e-3,
    psf_patch: int | str | None = "auto",
    sigma: float | str = 2.0,
    checkpoint_dir=None,
    fft_mode: str = "replicated",
) -> tuple:
    """
    Deconvolve a dataset over a device mesh. Returns
    ``(model, residual_image, psf)`` as numpy arrays; numerically
    matches the single-device solvers to gridder accuracy. The PSF
    comes from the already-staged sharded program so callers never
    build a separate single-device operator for it.

    ``algorithm`` selects the minor step: "hogbom" (Clark-accelerated
    above 4096 px, see models.clean.pick_psf_patch), "multiscale"
    (models.multiscale's minor cycle on the psum-reduced residual), or
    "fista" (accelerated proximal gradient; ``num_major * minor_iter
    // 10`` iterations, matching the single-device CLI convention).
    ``fft_mode="distributed"`` shards every plane FFT over the mesh
    in both directions (see parallel.sharded_invert) — per-cycle FFT
    FLOPs divide by the mesh size at production grid sizes.
    """
    if fft_mode not in ("replicated", "distributed"):
        raise ValueError(f"unknown fft_mode {fft_mode!r}")
    from contextlib import nullcontext

    step = recorder.step if recorder is not None else (
        lambda name: nullcontext()
    )

    staging = stage_sharded_inputs(
        reader,
        num_pixels,
        pixel_size_asec,
        mesh=mesh,
        row_chunks=row_chunks,
        freq_chunks=freq_chunks,
        epsilon=epsilon,
        do_wstacking=do_wstacking,
        weighting=weighting,
        robust=robust,
        step=step,
        sigma=sigma,
        common_w_grid=(fft_mode == "distributed"),
    )
    axis_name = staging.axis_name
    plan0 = staging.plans[0]
    distributed = fft_mode == "distributed"
    dist_kwargs = dict(
        mesh_axis=axis_name if distributed else None,
        num_shards=staging.mesh.devices.size if distributed else 1,
    )
    invert = build_invert(plan0, slot_input=True, **dist_kwargs)
    predict = build_predict(plan0, slot_output=True, **dist_kwargs)
    total_weight = staging.total_weight

    def unstack(arrays):
        return {
            key: value if _is_replicated(key) else value[0]
            for key, value in arrays.items()
        }

    def reduce_image(image):
        if distributed:
            # Grids were psum_scatter-reduced inside the invert.
            return image / total_weight
        return jax.lax.psum(image, axis_name) / total_weight

    def dirty_fn(arrays, vre, vim, wgt):
        arrays = unstack(arrays)
        image = invert(arrays, vre[0] * wgt[0], vim[0] * wgt[0])
        return reduce_image(image)

    def psf_fn(arrays, wgt):
        # Unit data visibilities in slot order are the staged w-shift
        # phase factors scaled by the slot weights.
        arrays = unstack(arrays)
        image = invert(
            arrays,
            wgt[0] * arrays["phase_cos"],
            wgt[0] * arrays["phase_sin"],
        )
        return reduce_image(image)

    def residual_of(arrays, vre, vim, wgt, dup_a, dup_b, model):
        """Exact residual image at ``model``, entirely in slot space
        (predict -> straddler group-sum -> weight -> invert -> psum)."""
        from ..ops.gridder import slot_group_sum

        model_re, model_im = predict(arrays, model)
        model_re, model_im = slot_group_sum(
            model_re, model_im, dup_a, dup_b
        )
        res_re = (vre - model_re) * wgt
        res_im = (vim - model_im) * wgt
        return reduce_image(invert(arrays, res_re, res_im))

    if algorithm not in ("hogbom", "multiscale", "fista"):
        raise ValueError(f"Unknown deconvolution algorithm {algorithm!r}")
    if psf_patch == "auto":
        psf_patch = pick_psf_patch(num_pixels)
    if algorithm == "multiscale":
        from ..models.multiscale import _multiscale_minor, scale_kernel

        max_scale = max(max(scales), 1.0)
        radius = int(np.ceil(2.0 * max_scale)) + 1
        ms_kernels = jnp.asarray(
            np.stack([scale_kernel(s, radius) for s in scales])
        )
        ms_biases = jnp.asarray(
            np.array(
                [1.0 - bias_slope * s / max_scale for s in scales],
                np.float32,
            )
        )

    def minor_step(residual, psf):
        if algorithm == "multiscale":
            delta, _ = _multiscale_minor(
                residual,
                psf,
                ms_kernels,
                ms_biases,
                gain=gain,
                max_iter=minor_iter,
                num_scales=len(scales),
                psf_patch=psf_patch,
            )
        else:
            delta, _ = hogbom_clean(
                residual,
                psf,
                gain=gain,
                max_iter=minor_iter,
                psf_patch=psf_patch,
            )
        return delta

    def cycle_fn(
        arrays, vre, vim, wgt, dup_a, dup_b, model, psf, residual
    ):
        # One predict+invert round trip per cycle: the minor cycle
        # consumes the residual carried from the previous cycle (the
        # dirty image initially) and only the post-update residual is
        # recomputed — matching the single-device solver's return
        # semantics (models/clean.py) at half the gridding cost.
        arrays = unstack(arrays)
        model = model + minor_step(residual, psf)
        return model, residual_of(
            arrays, vre[0], vim[0], wgt[0], dup_a[0], dup_b[0], model
        )

    psf_spmd = jax.jit(
        jax.shard_map(
            psf_fn,
            mesh=staging.mesh,
            in_specs=(staging.in_specs(), P(axis_name)),
            out_specs=P(),
            check_vma=False,
        )
    )
    dirty_spmd = jax.jit(
        jax.shard_map(
            dirty_fn,
            mesh=staging.mesh,
            in_specs=(
                staging.in_specs(),
                P(axis_name),
                P(axis_name),
                P(axis_name),
            ),
            out_specs=P(),
            check_vma=False,
        )
    )
    cycle_spmd = jax.jit(
        jax.shard_map(
            cycle_fn,
            mesh=staging.mesh,
            in_specs=(
                staging.in_specs(),
                P(axis_name),
                P(axis_name),
                P(axis_name),
                P(axis_name),
                P(axis_name),
                P(),
                P(),
                P(),
            ),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )

    with step("psf"):
        psf = psf_spmd(staging.stacked, staging.weights)
    with step("dirty"):
        residual = dirty_spmd(
            staging.stacked,
            staging.vis_re,
            staging.vis_im,
            staging.weights,
        )

    if algorithm == "fista":
        return _sharded_fista(
            staging,
            residual_of,
            unstack,
            psf,
            residual,
            num_pixels=num_pixels,
            num_iter=max(1, num_major * minor_iter // 10),
            lam_factor=lam_factor,
            step=step,
        )

    # Checkpoint/resume: replicated (model, residual) persisted after
    # every cycle, SIGTERM flushes the last completed state
    # (models/checkpoint.py). Only process 0 writes; every process
    # loads the same file from the shared filesystem on resume.
    from ..models.checkpoint import (
        MajorCycleCheckpoint,
        graceful_shutdown,
    )

    checkpoint = None
    start_cycle = 0
    model = jnp.zeros((num_pixels, num_pixels), jnp.float32)
    if checkpoint_dir is not None:
        checkpoint = MajorCycleCheckpoint(
            checkpoint_dir,
            {
                "num_pixels": num_pixels,
                "num_major": num_major,
                "gain": gain,
                "minor_iter": minor_iter,
                "algorithm": algorithm,
                "distributed": True,
            },
        )
        restored = checkpoint.load()
        if restored is not None:
            start_cycle, model_np, residual_np = restored
            model = jnp.asarray(model_np)
            residual = jnp.asarray(residual_np)

    state = {"cycle": start_cycle, "model": model, "res": residual}

    def flush():
        if checkpoint is not None and jax.process_index() == 0:
            checkpoint.save(
                state["cycle"], state["model"], state["res"]
            )

    with graceful_shutdown(flush):
        for cycle in range(start_cycle, num_major):
            with step("major_cycle"):
                model, residual = cycle_spmd(
                    staging.stacked,
                    staging.vis_re,
                    staging.vis_im,
                    staging.weights,
                    staging.dup_a,
                    staging.dup_b,
                    model,
                    psf,
                    residual,
                )
                state.update(
                    cycle=cycle + 1, model=model, res=residual
                )
                flush()
    return np.asarray(model), np.asarray(residual), np.asarray(psf)


def _sharded_fista(
    staging,
    residual_of,
    unstack,
    psf,
    dirty,
    *,
    num_pixels: int,
    num_iter: int,
    lam_factor: float,
    step,
):
    """
    Distributed FISTA (models/fista.py over the SPMD residual
    machinery): each iteration is ONE shard_map step — predict the
    acceleration point, psum-reduce the gradient, proximal update on
    the replicated image. The Lipschitz step size comes from a power
    iteration through the same sharded normal operator.
    """
    axis_name = staging.axis_name
    mesh = staging.mesh

    def grad_fn(arrays, vre, vim, wgt, dup_a, dup_b, image):
        arrays = unstack(arrays)
        # residual_of returns G* w (v - G y) / sum(w) = -gradient
        return -residual_of(
            arrays, vre[0], vim[0], wgt[0], dup_a[0], dup_b[0], image
        )

    grad_spmd = jax.jit(
        jax.shard_map(
            grad_fn,
            mesh=mesh,
            in_specs=(
                staging.in_specs(),
                P(axis_name),
                P(axis_name),
                P(axis_name),
                P(axis_name),
                P(axis_name),
                P(),
            ),
            out_specs=P(),
            check_vma=False,
        )
    )

    def gradient(image):
        return grad_spmd(
            staging.stacked,
            staging.vis_re,
            staging.vis_im,
            staging.weights,
            staging.dup_a,
            staging.dup_b,
            image,
        )

    with step("fista_step_size"):
        # Power iteration on the normal operator: gradient at v=0 is
        # +G* w G y / sum(w); reuse gradient() with the zero-data trick
        # grad(y) - grad(0) == normal(y) (gradient is affine in y).
        zero = jnp.zeros((num_pixels, num_pixels), jnp.float32)
        grad_at_zero = gradient(zero)
        x = jnp.ones((num_pixels, num_pixels), jnp.float32)
        eigenvalue = 1.0
        for _ in range(8):
            y = gradient(x) - grad_at_zero
            eigenvalue = float(jnp.sqrt(jnp.sum(y * y)))
            x = y / eigenvalue
        step_size = 1.0 / max(eigenvalue, 1e-6)

    lam = lam_factor * float(jnp.max(jnp.abs(dirty)))
    threshold = lam * step_size

    @jax.jit
    def prox_update(x, z_raw, t):
        z = jnp.sign(z_raw) * jnp.maximum(
            jnp.abs(z_raw) - threshold, 0.0
        )
        z = jnp.maximum(z, 0.0)
        t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        y_next = z + ((t - 1.0) / t_next) * (z - x)
        return z, y_next, t_next

    x = jnp.zeros((num_pixels, num_pixels), jnp.float32)
    y = x
    t = jnp.float32(1.0)
    for _ in range(num_iter):
        with step("fista_iter"):
            z_raw = y - step_size * gradient(y)
            x, y, t = prox_update(x, z_raw, t)

    with step("fista_residual"):
        residual = -gradient(x)
    return np.asarray(x), np.asarray(residual), np.asarray(psf)
