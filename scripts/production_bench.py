"""
Production-configuration proof: the reference's CSD3 run images
10240 x 10240 px at 1.1 asec (reference: slurm/csd3_icelake.sh:19-26).
This script runs that imaging configuration through the gridder on
one device — w-stacked invert and predict at epsilon=1e-4 over
MeerKAT-scale baselines — and prints a JSON line with shape/time
detail.

At sigma=1.5 the padded grid is 15360^2; the plane-at-a-time structure
keeps device memory at a few planes' footprint rather than nplanes
times one plane's split alloc.
"""

import json
import sys
import time

import numpy as np

NUM_PIXELS = 10240
PIXEL_ASEC = 1.1
EPSILON = 1e-4
NUM_TIMES = 4
NUM_ANTENNAS = 64  # 8064 rows
NUM_CHANNELS = 32  # ~258k visibility samples


def main() -> None:
    import jax
    import jax.numpy as jnp

    from ska_sdp_cip_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()

    from ska_sdp_cip_tpu.io.synth import synthetic_uvw
    from ska_sdp_cip_tpu.ops.gridder import (
        build_invert,
        build_predict,
        plan_device_arrays,
        split_complex,
    )
    from ska_sdp_cip_tpu.ops.plan import make_plan

    rng = np.random.default_rng(7)
    uvw, _ = synthetic_uvw(
        NUM_TIMES, NUM_ANTENNAS, max_baseline_m=7700.0, seed=11
    )
    freqs = np.linspace(1.40e9, 1.507e9, NUM_CHANNELS)
    shape = (len(uvw), NUM_CHANNELS)
    vis = (
        rng.normal(size=shape) + 1j * rng.normal(size=shape)
    ).astype(np.complex64)
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    pixel_size_lm = float(np.sin(np.radians(PIXEL_ASEC / 3600.0)))

    # sigma="auto" resolves to 1.5 here: the production config is
    # FFT-dominated (258k vis on a 20480^2 padded grid at sigma=2),
    # and the 1.5 grid is 44% smaller per w-plane. Override with
    # CIP_SIGMA to compare (e.g. CIP_SIGMA=2.0).
    import os

    sigma_env = os.environ.get("CIP_SIGMA", "auto")
    sigma = sigma_env if sigma_env == "auto" else float(sigma_env)
    t0 = time.time()
    plan = make_plan(
        uvw, freqs, NUM_PIXELS, pixel_size_lm, epsilon=EPSILON,
        sigma=sigma,
    )
    plan_seconds = time.time() - t0
    t0 = time.time()
    arrays = jax.block_until_ready(plan_device_arrays(plan))
    stage_seconds = time.time() - t0

    invert = build_invert(plan)
    re, im = split_complex((vis * wgt).ravel())
    re_pad = np.zeros(plan.num_vis, np.float32)
    im_pad = np.zeros(plan.num_vis, np.float32)
    re_pad[: len(re)] = re
    im_pad[: len(im)] = im

    @jax.jit
    def run(arrays, re, im, seed):
        image = invert(arrays, re * (1.0 + seed * 1e-30), im)
        return image[0, 0], jnp.max(jnp.abs(image))

    t0 = time.time()
    _, peak = run(
        arrays,
        jnp.asarray(re_pad),
        jnp.asarray(im_pad),
        jnp.float32(0.0),
    )
    peak = float(np.asarray(peak))
    first_seconds = time.time() - t0
    t0 = time.time()
    _, peak2 = run(
        arrays,
        jnp.asarray(re_pad),
        jnp.asarray(im_pad),
        jnp.float32(1.0),
    )
    _ = float(np.asarray(peak2))
    invert_seconds = time.time() - t0

    # Degrid at production grid size: proves the padded spectral
    # planes fit alongside the predict pipeline's buffers.
    predict = build_predict(plan)

    @jax.jit
    def run_predict(arrays, image, seed):
        out_re, out_im = predict(
            arrays, image * (1.0 + seed * 1e-30)
        )
        return (
            jnp.max(jnp.abs(out_re)) + jnp.max(jnp.abs(out_im)),
            out_re[0],
        )

    image = jnp.ones((NUM_PIXELS, NUM_PIXELS), jnp.float32)
    t0 = time.time()
    vpk, _ = run_predict(arrays, image, jnp.float32(0.0))
    vpk = float(np.asarray(vpk))
    predict_first_seconds = time.time() - t0
    t0 = time.time()
    vpk2, _ = run_predict(arrays, image, jnp.float32(1.0))
    _ = float(np.asarray(vpk2))
    predict_seconds = time.time() - t0

    print(
        json.dumps(
            {
                "config": "CSD3 production (10240 px @ 1.1 asec)",
                "device": {
                    "platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()),
                },
                "sigma": plan.sigma,
                "support": plan.support,
                "num_vis": plan.num_vis_data,
                "ngrid": plan.ngrid,
                "nalloc": [plan.nalloc_x, plan.nalloc_y],
                "nplanes": plan.nplanes,
                "num_blocks": plan.num_blocks,
                "plan_seconds": round(plan_seconds, 2),
                "stage_seconds": round(stage_seconds, 2),
                "compile_plus_first_seconds": round(first_seconds, 2),
                "invert_seconds": round(invert_seconds, 3),
                "predict_compile_plus_first_seconds": round(
                    predict_first_seconds, 2
                ),
                "predict_seconds": round(predict_seconds, 3),
                "image_abs_max": peak,
                "predict_abs_max": vpk,
                "finite": bool(
                    np.isfinite(peak) and np.isfinite(vpk)
                ),
            }
        )
    )
    if not np.isfinite(peak):
        sys.exit(1)


if __name__ == "__main__":
    main()
