#!/usr/bin/env python3
"""
Smoke test of the imager on one GPU: the main path end to end, through
the entry points a user calls, checked against the float64 DFT oracle.

    python chip_smoke.py               # phases 1-4, one GPU
    python chip_smoke.py --four-cards  # phase 5 only, four GPUs

Phases (each prints one JSON line):

1. device — platform, kind, count, the card's name and power limit,
   the native planner build, and the ``gpu``-marked tests run
   in-process (this process holds the card);
2. bench width — the bench observation (20 times x 96 antennas x 64
   channels, 5,836,800 visibilities) written to a dataset and imaged
   through the ``tpu-cip`` CLI's ``main()`` at 2048 px, 5", eps=1e-4,
   w-stacking, sigma 2.0, ``--clean 3``; checked against the sampled
   DFT, the adjoint identity and a falling major-cycle residual;
3. production width — 4 x 64 antennas x 32 channels at 10240 px,
   1.1", sigma 1.5 (15360^2 padded grid) through ``dirty_image`` /
   ``predict_visibilities``, same sampled-DFT and adjoint checks;
4. findings, not gated — the four-step matmul DFT at HIGHEST against
   ``jnp.fft.fft2`` on complex64, the sigma cost-model inputs, and
   peak device memory;
5. ``--four-cards`` — the sharded drivers on a 4-device mesh against
   the single-device invert and major cycle.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Any failed check or phase exits non-zero without it, as does a run
where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, redirect_stdout
from dataclasses import dataclass
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

EPSILON = 1e-4
#: Sampled-DFT contract: max |error| / max |DFT| over the samples
#: (tests/test_gridder_accuracy.py).
DFT_RTOL = 1e-4
NUM_SAMPLES = 64
#: <invert(v), img> == Re <v, predict(img)> (tests/test_gridder_accuracy.py).
ADJOINT_RTOL = 1e-4
#: Sharded against single-device output: the reference's
#: distributed-vs-local tolerance.
SHARDED_RTOL = 1e-5
FFT_SIZES = (4096, 15360)


@dataclass(frozen=True)
class Observation:
    """A synthetic observation and the imaging configuration for it."""

    num_times: int
    num_antennas: int
    num_channels: int
    num_pixels: int
    pixel_asec: float
    sigma: float
    freq_lo: float = 1.40e9
    freq_hi: float = 1.507e9
    max_baseline_m: float = 7700.0
    seed: int = 42

    @property
    def freqs(self) -> np.ndarray:
        return np.linspace(self.freq_lo, self.freq_hi, self.num_channels)

    @property
    def pixel_size_lm(self) -> float:
        return float(np.sin(np.radians(self.pixel_asec / 3600.0)))


#: bench.py's observation: 91,200 rows x 64 channels.
BENCH = Observation(20, 96, 64, 2048, 5.0, 2.0)
#: scripts/production_bench.py's observation: 8,064 rows x 32 channels.
PRODUCTION = Observation(4, 64, 32, 10240, 1.1, 1.5, seed=11)
CLEAN_CYCLES = 3
CLEAN_GAIN = 0.1
CLEAN_MINOR_ITER = 100


class SmokeFailure(RuntimeError):
    """A check of the smoke run failed."""


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def log(message: str) -> None:
    """Progress on standard error, with seconds since start."""
    elapsed = time.perf_counter() - _START
    print(f"[chip_smoke {elapsed:8.1f}s] {message}", file=sys.stderr, flush=True)


def card_info() -> list[str]:
    """``nvidia-smi`` name and power limit, one line per card, read by a
    child process that does not import JAX."""
    result = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return [line.strip() for line in result.stdout.splitlines() if line]


def device_fields(devices=None) -> dict:
    import jax

    devices = devices or jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def peak_bytes(device=None) -> int:
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def warm_seconds(label: str, fn) -> tuple[float, float, object]:
    """(first-call seconds incl. compilation, warm seconds, result)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = jax.block_until_ready(fn())
    warm = time.perf_counter() - t0
    log(f"{label}: first call {first:.3f} s, warm {warm:.4f} s")
    return first, warm, result


def build_native() -> str:
    """Build the native planner from the committed sources; on failure
    the planner's numpy fallback runs, and the result says so."""
    if not (REPO / "native" / "Makefile").is_file():
        return "numpy fallback: no native sources"
    result = subprocess.run(
        ["make", "-C", str(REPO / "native")],
        capture_output=True,
        text=True,
        timeout=300,
    )
    if result.returncode:
        tail = (result.stderr or result.stdout).strip()[-300:]
        return f"numpy fallback: build failed: {tail}"
    from ska_sdp_cip_tpu import native

    return "built" if native.available() else "numpy fallback: not loaded"


def sample_pixels(image: np.ndarray, num: int, seed: int = 0) -> np.ndarray:
    """``num`` distinct (i, j) pixels: the brightest, the four corners,
    the rest drawn at random."""
    npix = image.shape[0]
    brightest = np.unravel_index(np.argmax(np.abs(image)), image.shape)
    chosen = [tuple(int(v) for v in brightest)]
    for corner in ((0, 0), (0, npix - 1), (npix - 1, 0), (npix - 1, npix - 1)):
        if corner not in chosen:
            chosen.append(corner)
    rng = np.random.default_rng(seed)
    while len(chosen) < min(num, npix * npix):
        pixel = tuple(int(v) for v in rng.integers(0, npix, size=2))
        if pixel not in chosen:
            chosen.append(pixel)
    return np.asarray(chosen, dtype=np.int64)


def sampled_dft_error(
    image, uvw, freqs, weighted_vis, pixel_size_lm, pixels, scale=1.0
) -> float:
    """max |image - DFT| / max |DFT| over the sampled pixels; the DFT
    is float64 and ``scale`` multiplies it (e.g. 1 / total weight)."""
    from ska_sdp_cip_tpu.ops.dft import dirty_pixels_dft

    reference = scale * dirty_pixels_dft(
        uvw, freqs, weighted_vis, pixels, image.shape[0], pixel_size_lm
    )
    ours = np.asarray(image, np.float64)[pixels[:, 0], pixels[:, 1]]
    return float(np.max(np.abs(ours - reference)) / np.max(np.abs(reference)))


def adjoint_error(image, dirty, model_vis, weighted_vis) -> float:
    """|<dirty, image> - Re <model_vis, weighted_vis>| relative to the
    right-hand side."""
    lhs = float(
        np.dot(
            np.asarray(image, np.float64).ravel(),
            np.asarray(dirty, np.float64).ravel(),
        )
    )
    rhs = float(
        np.real(
            np.vdot(
                np.asarray(model_vis, np.complex128).ravel(),
                np.asarray(weighted_vis, np.complex128).ravel(),
            )
        )
    )
    return abs(lhs - rhs) / abs(rhs)


def count_carry_copies(hlo_text: str, shape: tuple) -> int:
    """Copies of an f32 array of ``shape`` in compiled HLO text."""
    import re

    dims = ",".join(str(d) for d in shape)
    pattern = re.compile(
        r"= f32\[" + dims + r"\]\{[^}]*\} copy(-start)?\("
    )
    return sum(1 for line in hlo_text.splitlines() if pattern.search(line))


@contextmanager
def _argv(argv):
    saved = sys.argv
    sys.argv = list(argv)
    try:
        yield
    finally:
        sys.argv = saved


def run_cli(argv: list[str]) -> None:
    """Run the ``tpu-cip`` console entry point in this process."""
    from ska_sdp_cip_tpu.apps.pipeline_app import main

    with _argv(["tpu-cip", *argv]):
        main()


# ---------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_device(run_tests: bool = True) -> dict:
    import pytest

    result = {"device": device_fields(), "native": build_native()}
    if run_tests:
        outcomes = _Outcomes()
        saved = dict(os.environ)
        try:
            # pytest's report goes to standard error: standard output
            # carries only the phase lines.
            with redirect_stdout(sys.stderr):
                code = pytest.main(
                    [
                        "-m", "gpu", "-q", "-p", "no:cacheprovider",
                        str(REPO / "tests"),
                    ],
                    plugins=[outcomes],
                )
        finally:
            os.environ.clear()
            os.environ.update(saved)
        result["gpu_tests"] = dict(outcomes.counts, exit_code=int(code))
        check(code == 0, f"gpu-marked tests failed: {result['gpu_tests']}")
        check(
            outcomes.counts["passed"] > 0
            and outcomes.counts["skipped"] == 0,
            f"gpu-marked tests did not all run: {result['gpu_tests']}",
        )
    return result


def phase_bench(workdir: Path, obs: Observation = BENCH) -> dict:
    """The bench observation through the CLI, then the checks."""
    import jax.numpy as jnp

    from ska_sdp_cip_tpu.invert import StokesIGridderInput
    from ska_sdp_cip_tpu.io.synth import make_synthetic_dataset
    from ska_sdp_cip_tpu.io.visibility_dataset import VisibilityReader
    from ska_sdp_cip_tpu.models import MeasurementOperator
    from ska_sdp_cip_tpu.models.clean import (
        build_major_cycle_step,
        hogbom_clean,
        pick_psf_patch,
    )

    t0 = time.perf_counter()
    path = make_synthetic_dataset(
        workdir / "bench.vz",
        num_times=obs.num_times,
        num_antennas=obs.num_antennas,
        channel_frequencies=obs.freqs,
        seed=obs.seed,
    )
    data_seconds = time.perf_counter() - t0
    log(f"dataset written in {data_seconds:.1f} s; running the CLI")

    out = workdir / "dirty.npy"
    t0 = time.perf_counter()
    run_cli(
        [
            str(path), str(out),
            "-n", str(obs.num_pixels),
            "-p", str(obs.pixel_asec),
            "-e", str(EPSILON),
            "--sigma", str(obs.sigma),
            "--clean", str(CLEAN_CYCLES),
            "--gain", str(CLEAN_GAIN),
            "--minor-iter", str(CLEAN_MINOR_ITER),
        ]
    )
    cli_seconds = time.perf_counter() - t0
    log(f"CLI dirty + clean in {cli_seconds:.1f} s; sampled DFT")
    dirty = np.load(out)
    cli_residual = np.load(out.with_suffix(".residual.npy"))
    shape = (obs.num_pixels, obs.num_pixels)
    check(dirty.shape == shape, f"dirty image shape {dirty.shape}")
    check(bool(np.isfinite(dirty).all()), "dirty image not finite")
    check(bool(np.isfinite(cli_residual).all()), "residual not finite")

    gi = StokesIGridderInput.from_reader(VisibilityReader(path))
    weights = gi.effective_weights()
    weighted = gi.visibilities * weights
    num_vis = int(gi.visibilities.size)
    pixels = sample_pixels(dirty, NUM_SAMPLES)
    dft_err = sampled_dft_error(
        dirty, gi.uvw, obs.freqs, weighted, obs.pixel_size_lm, pixels,
        scale=1.0 / float(weights.sum()),
    )
    check(dft_err < DFT_RTOL, f"bench dirty vs DFT: {dft_err:.3e}")
    log(f"bench DFT error {dft_err:.3e}; operator timings")

    op = MeasurementOperator.build(
        gi.uvw, obs.freqs, weights, obs.num_pixels, obs.pixel_size_lm,
        epsilon=EPSILON, sigma=obs.sigma,
    )
    slots = op.stage(gi.visibilities)
    image = jnp.asarray(
        np.random.default_rng(3).normal(size=shape).astype(np.float32)
    )
    w_re = np.ascontiguousarray(weighted.real.ravel(), np.float32)
    w_im = np.ascontiguousarray(weighted.imag.ravel(), np.float32)
    inv_first, inv_warm, _ = warm_seconds(
        "bench invert", lambda: op.dirty_image(slots)
    )
    pre_first, pre_warm, model_vis = warm_seconds(
        "bench predict", lambda: op.forward(image)
    )
    adjoint = op.adjoint(jnp.asarray(w_re), jnp.asarray(w_im))
    model_c = np.asarray(model_vis[0]) + 1j * np.asarray(model_vis[1])
    adj_err = adjoint_error(
        image, adjoint, model_c[:num_vis], weighted.ravel()
    )
    check(adj_err < ADJOINT_RTOL, f"bench adjoint identity: {adj_err:.3e}")
    log(f"bench adjoint error {adj_err:.3e}; major cycles")

    psf = op.psf()
    psf_patch = pick_psf_patch(obs.num_pixels)
    residual = op.dirty_image(slots)
    model = jnp.zeros(shape, jnp.float32)
    norms = [float(jnp.linalg.norm(residual))]
    for _ in range(CLEAN_CYCLES):
        delta, _ = hogbom_clean(
            residual, psf, gain=CLEAN_GAIN, max_iter=CLEAN_MINOR_ITER,
            psf_patch=psf_patch,
        )
        model = model + delta
        residual = -op.residual_gradient(model, slots)
        norms.append(float(jnp.linalg.norm(residual)))
    check(
        all(b < a for a, b in zip(norms, norms[1:])),
        f"major-cycle residual norms do not fall: {norms}",
    )
    check(
        float(np.linalg.norm(cli_residual)) < float(np.linalg.norm(dirty)),
        "CLI residual is not below the dirty image",
    )
    step = build_major_cycle_step(
        op, gain=CLEAN_GAIN, minor_iter=CLEAN_MINOR_ITER
    )
    cyc_first, cyc_warm, _ = warm_seconds(
        "bench major cycle", lambda: step(model, slots.re, slots.im)
    )
    return {
        "num_vis": num_vis,
        "nplanes": op.plan.nplanes,
        "support": op.plan.support,
        "ngrid": op.plan.ngrid,
        "dft_rel_error": dft_err,
        "adjoint_rel_error": adj_err,
        "residual_norms": norms,
        "seconds": {
            "dataset": data_seconds,
            "cli_dirty_plus_clean": cli_seconds,
            "invert_first": inv_first,
            "invert_warm": inv_warm,
            "predict_first": pre_first,
            "predict_warm": pre_warm,
            "major_cycle_first": cyc_first,
            "major_cycle_warm": cyc_warm,
        },
        "peak_bytes_in_use": peak_bytes(),
    }


def phase_production(obs: Observation = PRODUCTION) -> dict:
    """Production width through dirty_image / predict_visibilities."""
    import jax.numpy as jnp

    from ska_sdp_cip_tpu.io.synth import synthetic_uvw
    from ska_sdp_cip_tpu.models import MeasurementOperator
    from ska_sdp_cip_tpu.models.clean import build_major_cycle_step
    from ska_sdp_cip_tpu.ops.gridder import (
        build_invert,
        build_predict,
        dirty_image,
        plan_device_arrays,
        predict_visibilities,
        stage_slot_vis,
    )
    from ska_sdp_cip_tpu.ops.plan import make_plan

    rng = np.random.default_rng(7)
    uvw, _ = synthetic_uvw(
        obs.num_times, obs.num_antennas,
        max_baseline_m=obs.max_baseline_m, seed=obs.seed,
    )
    freqs = obs.freqs
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    weighted = vis * wgt
    kwargs = dict(epsilon=EPSILON, sigma=obs.sigma)

    t0 = time.perf_counter()
    dirty = dirty_image(
        uvw, freqs, vis, wgt, obs.num_pixels, obs.pixel_size_lm, **kwargs
    )
    invert_first = time.perf_counter() - t0
    log(f"production dirty_image in {invert_first:.1f} s")
    check(bool(np.isfinite(dirty).all()), "production dirty not finite")
    pixels = sample_pixels(dirty, NUM_SAMPLES)
    dft_err = sampled_dft_error(
        dirty, uvw, freqs, weighted, obs.pixel_size_lm, pixels
    )
    check(dft_err < DFT_RTOL, f"production dirty vs DFT: {dft_err:.3e}")

    image = rng.normal(size=(obs.num_pixels,) * 2).astype(np.float32)
    t0 = time.perf_counter()
    model_vis = predict_visibilities(
        uvw, freqs, image, obs.pixel_size_lm, **kwargs
    )
    predict_first = time.perf_counter() - t0
    log(f"production predict_visibilities in {predict_first:.1f} s")
    adj_err = adjoint_error(image, dirty, model_vis, weighted)
    check(
        adj_err < ADJOINT_RTOL, f"production adjoint identity: {adj_err:.3e}"
    )

    # Warm times of the same programs (persistent-cache hits).
    plan = make_plan(uvw, freqs, obs.num_pixels, obs.pixel_size_lm, **kwargs)
    slot_arrays = plan_device_arrays(plan, slot_mode=True)
    full_arrays = plan_device_arrays(plan)
    s_re, s_im = stage_slot_vis(
        plan, weighted.real.ravel(), weighted.imag.ravel()
    )
    s_re, s_im = jnp.asarray(s_re), jnp.asarray(s_im)
    invert = build_invert(plan, slot_input=True)
    predict = build_predict(plan)
    image_dev = jnp.asarray(image)
    _, invert_warm, _ = warm_seconds(
        "production invert", lambda: invert(slot_arrays, s_re, s_im)
    )
    _, predict_warm, _ = warm_seconds(
        "production predict", lambda: predict(full_arrays, image_dev)
    )
    hlo = invert.lower(slot_arrays, s_re, s_im).compile().as_text()
    carry_copies = count_carry_copies(hlo, (plan.nalloc_x, plan.nalloc_y))
    log(f"production invert HLO: {carry_copies} copies of the grid carry")

    op = MeasurementOperator.build(
        uvw, freqs, wgt, obs.num_pixels, obs.pixel_size_lm, **kwargs
    )
    slots = op.stage(vis)
    step = build_major_cycle_step(
        op, gain=CLEAN_GAIN, minor_iter=CLEAN_MINOR_ITER
    )
    model0 = jnp.zeros((obs.num_pixels,) * 2, jnp.float32)
    cyc_first, cyc_warm, model1 = warm_seconds(
        "production major cycle", lambda: step(model0, slots.re, slots.im)
    )
    check(bool(jnp.isfinite(model1).all()), "production cycle not finite")
    return {
        "num_vis": int(vis.size),
        "ngrid": plan.ngrid,
        "nalloc": [plan.nalloc_x, plan.nalloc_y],
        "nplanes": plan.nplanes,
        "support": plan.support,
        "dft_rel_error": dft_err,
        "adjoint_rel_error": adj_err,
        "carry_copies_in_invert_hlo": carry_copies,
        "seconds": {
            "invert_first": invert_first,
            "invert_warm": invert_warm,
            "predict_first": predict_first,
            "predict_warm": predict_warm,
            "major_cycle_first": cyc_first,
            "major_cycle_warm": cyc_warm,
        },
        "peak_bytes_in_use": peak_bytes(),
    }


def phase_fft(sizes=FFT_SIZES) -> dict:
    """One plane's four-step DFT at HIGHEST against cuFFT (complex64),
    each against numpy float64 on one sampled output row."""
    import jax
    import jax.numpy as jnp

    from ska_sdp_cip_tpu.ops.fft import fft2_split, fft_plan_arrays, make_fft_plan

    four_step = jax.jit(
        lambda f, re, im: fft2_split(re, im, f, sign=-1)
    )
    library = jax.jit(lambda re, im: jnp.fft.fft2(jax.lax.complex(re, im)))
    results = {}
    for n in sizes:
        key_re, key_im = jax.random.split(jax.random.PRNGKey(n))
        re = jax.random.normal(key_re, (n, n), jnp.float32)
        im = jax.random.normal(key_im, (n, n), jnp.float32)
        factors = fft_plan_arrays(make_fft_plan(n))
        four_first, four_warm, (out_re, out_im) = warm_seconds(
            f"four-step DFT {n}^2", lambda: four_step(factors, re, im)
        )
        row = n // 3
        four_row = np.asarray(out_re[row]) + 1j * np.asarray(out_im[row])
        del out_re, out_im
        lib_first, lib_warm, out = warm_seconds(
            f"jnp.fft.fft2 {n}^2", lambda: library(re, im)
        )
        lib_row = np.asarray(out[row])
        del out
        x = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
        twiddle = np.exp(-2j * np.pi * row * np.arange(n) / n)
        reference = np.fft.fft(twiddle @ x)
        del x
        scale = np.max(np.abs(reference))
        results[str(n)] = {
            "four_step_highest": {
                "first_seconds": four_first,
                "warm_seconds": four_warm,
                "row_rel_error": float(
                    np.max(np.abs(four_row - reference)) / scale
                ),
            },
            "jnp_fft_fft2_complex64": {
                "first_seconds": lib_first,
                "warm_seconds": lib_warm,
                "row_rel_error": float(
                    np.max(np.abs(lib_row - reference)) / scale
                ),
            },
        }
    return results


def sigma_cost_inputs(bench: dict, fft: dict) -> dict:
    """Per-unit costs for ops/plan.py's sigma cost model: gridding
    seconds per (visibility x plane visit), taken as the bench invert
    minus its plane FFTs, and plane-FFT seconds per grid cell."""
    n_small = str(bench["ngrid"])
    fft_small = fft.get(n_small, {}).get("four_step_highest")
    largest = fft[str(max(int(k) for k in fft))]["four_step_highest"]
    out = {
        "fft_per_cell_plane": largest["warm_seconds"]
        / float(max(int(k) for k in fft)) ** 2
    }
    if fft_small is not None:
        grid = (
            bench["seconds"]["invert_warm"]
            - bench["nplanes"] * fft_small["warm_seconds"]
        )
        out["grid_per_vis_plane"] = grid / (
            bench["num_vis"] * bench["support"]
        )
    return out


class _MemoryRecorder:
    """Task recorder that reads every device's memory at each step's
    end (the staged shards are alive at the end of ``stage_shards``)."""

    def __init__(self, devices):
        self.devices = devices
        self.bytes_in_use = {}

    @contextmanager
    def step(self, name):
        yield
        self.bytes_in_use[name] = [
            (d.memory_stats() or {}).get("bytes_in_use")
            for d in self.devices
        ]


def phase_four_cards(
    workdir: Path, obs: Observation = BENCH, num_devices: int = 4
) -> dict:
    """Sharded invert (both FFT modes) and the sharded major cycle on a
    ``num_devices`` mesh against the single-device drivers."""
    import jax

    from ska_sdp_cip_tpu.invert import StokesIGridderInput, invert_dataset
    from ska_sdp_cip_tpu.io.synth import make_synthetic_dataset
    from ska_sdp_cip_tpu.io.visibility_dataset import VisibilityReader
    from ska_sdp_cip_tpu.models import MeasurementOperator, major_cycle_clean
    from ska_sdp_cip_tpu.parallel.mesh import make_device_mesh
    from ska_sdp_cip_tpu.parallel.sharded_clean import (
        sharded_major_cycle_clean,
    )
    from ska_sdp_cip_tpu.parallel.sharded_invert import (
        sharded_invert_dataset,
    )

    devices = jax.devices()[:num_devices]
    check(
        len(devices) == num_devices,
        f"need {num_devices} devices, have {len(jax.devices())}",
    )
    path = make_synthetic_dataset(
        workdir / "bench.vz",
        num_times=obs.num_times,
        num_antennas=obs.num_antennas,
        channel_frequencies=obs.freqs,
        seed=obs.seed,
    )
    reader = VisibilityReader(path)
    mesh = make_device_mesh(num_devices)
    common = dict(epsilon=EPSILON, sigma=obs.sigma)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    t0 = time.perf_counter()
    single = invert_dataset(
        reader, obs.num_pixels, obs.pixel_asec, **common
    )
    seconds = {"single_invert": time.perf_counter() - t0}
    errors = {}
    memory = {}
    for mode in ("replicated", "distributed"):
        recorder = _MemoryRecorder(devices)
        t0 = time.perf_counter()
        sharded = sharded_invert_dataset(
            reader, obs.num_pixels, obs.pixel_asec, mesh=mesh,
            fft_mode=mode, recorder=recorder, **common,
        )
        seconds[f"sharded_invert_{mode}"] = time.perf_counter() - t0
        errors[f"invert_{mode}"] = rel(sharded, single)
        memory[mode] = recorder.bytes_in_use["stage_shards"]

    # Shallow cycles: deep CLEAN runs diverge pixel-wise between any
    # two numerically different gridders (argmax ties), see
    # tests/test_sharded_clean.py.
    clean = dict(num_major=2, gain=0.3, minor_iter=6)
    t0 = time.perf_counter()
    model_s, residual_s, _ = sharded_major_cycle_clean(
        reader, obs.num_pixels, obs.pixel_asec, mesh=mesh,
        **clean, **common,
    )
    seconds["sharded_major_cycle"] = time.perf_counter() - t0
    gi = StokesIGridderInput.from_reader(reader)
    op = MeasurementOperator.build(
        gi.uvw, obs.freqs, gi.effective_weights(), obs.num_pixels,
        obs.pixel_size_lm, **common,
    )
    t0 = time.perf_counter()
    model_l, residual_l = major_cycle_clean(
        op, gi.visibilities.ravel(), **clean
    )
    seconds["single_major_cycle"] = time.perf_counter() - t0
    scale = float(np.max(np.abs(np.asarray(residual_l))))
    errors["major_cycle_model"] = float(
        np.max(np.abs(np.asarray(model_s) - np.asarray(model_l))) / scale
    )
    errors["major_cycle_residual"] = rel(residual_s, residual_l)
    result = {
        "rel_errors": errors,
        "bytes_in_use_after_staging": memory,
        "peak_bytes_in_use": [peak_bytes(d) for d in devices],
        "seconds": seconds,
    }
    for name, err in errors.items():
        check(err < SHARDED_RTOL, f"sharded {name}: {err:.3e}")
    for mode, per_device in memory.items():
        # Platforms without memory statistics (the CPU) report None.
        check(
            all(b is None or b > 0 for b in per_device),
            f"{mode}: a card holds no shard: {per_device}",
        )
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the sharded drivers on a 4-GPU mesh (phase 5)",
    )
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
            "nothing was run",
            file=sys.stderr,
        )
        return 2
    from ska_sdp_cip_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    cards = card_info()
    for line in cards:
        print(line, flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        if args.four_cards:
            log("phase 5: sharded drivers on four cards")
            emit("four_cards", cards=cards, **phase_four_cards(workdir))
        else:
            log("phase 1: device, native build, gpu-marked tests")
            emit("device", cards=cards, **phase_device())
            log("phase 2: bench width through the CLI")
            bench = phase_bench(workdir)
            emit("bench_width", cards=cards, **bench)
            log("phase 3: production width")
            emit("production_width", cards=cards, **phase_production())
            log("phase 4: FFT findings")
            fft = phase_fft()
            emit(
                "findings",
                cards=cards,
                fft=fft,
                sigma_cost=sigma_cost_inputs(bench, fft),
                peak_bytes_in_use=peak_bytes(),
            )
    print(json.dumps({"ok": True, "device": device_fields()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
