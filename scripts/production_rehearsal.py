"""
End-to-end production rehearsal: the reference's intended production
flow (reference: slurm/csd3_icelake.sh:19-26 + the tiled-gridder north
star, SURVEY.md section 0) run start to finish with a mid-run
preemption:

  1. synthesize a VZ dataset with known sky truth;
  2. reorder it into UVW tile chunks (tpu-cip-reorder-uvw machinery);
  3. dirty image FROM THE TILE STORE (sharded_invert_tile_chunks) and
     cross-check against the direct dataset invert;
  4. distributed CLEAN with checkpointing, SIGTERM'd mid-run (the
     reference's SLURM pre-kill signal, csd3_icelake.sh:13), then
     resumed to completion — asserting the resume actually skipped the
     completed cycles.

Prints one JSON line with per-stage timings. Defaults are a CPU-mesh
smoke (CI-sized); ``--production`` runs the 10240-px CSD3 imaging
config on the attached accelerator.

Usage:
  python scripts/production_rehearsal.py [--production] [--outdir DIR]
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# Run as a bare script: sys.path[0] is scripts/, not the repo root, so
# the package is only importable if pip-installed — bootstrap instead.
sys.path.insert(0, str(REPO))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--production", action="store_true")
    parser.add_argument("--outdir", type=Path, default=None)
    parser.add_argument("--devices", type=int, default=None)
    args = parser.parse_args()

    if args.production:
        num_pixels, pixel_asec = 10240, 1.1
        num_times, num_antennas, num_channels = 4, 64, 32
        tile_size = (30000.0, 30000.0, 60000.0)
        num_major, minor_iter = 3, 200
    else:
        num_pixels, pixel_asec = 256, 15.0
        num_times, num_antennas, num_channels = 8, 24, 4
        tile_size = (3000.0, 3000.0, 6000.0)
        num_major, minor_iter = 3, 10

    outdir = args.outdir or Path("rehearsal_out")
    outdir.mkdir(parents=True, exist_ok=True)

    import numpy as np

    from ska_sdp_cip_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()

    from ska_sdp_cip_tpu.io.synth import make_synthetic_dataset
    from ska_sdp_cip_tpu.io.visibility_dataset import VisibilityReader
    from ska_sdp_cip_tpu.invert import (
        invert_dataset,
        pixel_size_lm_from_asec,
    )
    from ska_sdp_cip_tpu.parallel.mesh import make_device_mesh
    from ska_sdp_cip_tpu.uvw_tiling import reorder_by_uvw_tile
    from ska_sdp_cip_tpu.uvw_tiling.tiled_invert import (
        sharded_invert_tile_chunks,
    )

    timings = {}
    mesh = make_device_mesh(args.devices)

    # 1. Synthesize
    t0 = time.time()
    dataset = outdir / "obs.vz"
    if not dataset.exists():
        make_synthetic_dataset(
            dataset,
            num_times=num_times,
            num_antennas=num_antennas,
            channel_frequencies=np.linspace(
                1.40e9, 1.507e9, num_channels
            ),
            seed=1234,
        )
    reader = VisibilityReader(dataset)
    timings["synthesize_s"] = round(time.time() - t0, 2)

    # 2. Reorder into UVW tiles
    t0 = time.time()
    tiles_dir = outdir / "tiles"
    tiles_dir.mkdir(exist_ok=True)
    reorder_by_uvw_tile(
        reader, tile_size, tiles_dir, max_vis_per_chunk=5_000_000
    )
    chunk_files = sorted(tiles_dir.glob("tile_iu*chunk*.npz"))
    assert chunk_files, "reorder produced no tile chunks"
    timings["reorder_s"] = round(time.time() - t0, 2)
    timings["tile_chunks"] = len(chunk_files)

    # 3. Dirty image from the tile store; cross-check vs direct invert
    t0 = time.time()
    tiled_image = sharded_invert_tile_chunks(
        chunk_files,
        reader.channel_frequencies(),
        num_pixels,
        pixel_size_lm_from_asec(pixel_asec),
        mesh=mesh,
    )
    timings["tiled_invert_s"] = round(time.time() - t0, 2)
    t0 = time.time()
    direct = invert_dataset(reader, num_pixels, pixel_asec)
    timings["direct_invert_s"] = round(time.time() - t0, 2)
    rel = float(
        np.abs(tiled_image - direct).max() / np.abs(direct).max()
    )
    timings["tiled_vs_direct_rel"] = rel
    assert rel < 1e-3, f"tiled invert mismatch: {rel}"

    # 4. Distributed CLEAN, preempted mid-run, resumed to completion.
    # The clean runs in a child process so THIS process can deliver
    # SIGTERM exactly the way SLURM's --signal=B:TERM@120 would.
    ckpt_dir = outdir / "ckpt"
    child_code = f"""
import sys, numpy as np
sys.path.insert(0, {str(REPO)!r})
from ska_sdp_cip_tpu.utils.compile_cache import configure_compile_cache
configure_compile_cache()
from ska_sdp_cip_tpu.io.visibility_dataset import VisibilityReader
from ska_sdp_cip_tpu.parallel.mesh import make_device_mesh
from ska_sdp_cip_tpu.parallel.sharded_clean import sharded_major_cycle_clean
model, residual, psf = sharded_major_cycle_clean(
    VisibilityReader({str(dataset)!r}),
    {num_pixels}, {pixel_asec},
    mesh=make_device_mesh({args.devices!r}),
    num_major={num_major}, minor_iter={minor_iter},
    checkpoint_dir={str(ckpt_dir)!r},
)
np.save({str(outdir / 'model.npy')!r}, model)
np.save({str(outdir / 'residual.npy')!r}, residual)
print("CLEAN_DONE", flush=True)
"""
    env = dict(os.environ)

    def run_clean(kill_after=None):
        proc = subprocess.Popen(
            [sys.executable, "-c", child_code],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        if kill_after is not None:
            time.sleep(kill_after)
            proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=3600)
        return proc.returncode, out.decode(errors="replace")

    from ska_sdp_cip_tpu.models.checkpoint import CHECKPOINT_NAME

    ckpt_path = ckpt_dir / CHECKPOINT_NAME

    # First launch: wait until at least one cycle checkpointed, then
    # SIGTERM (bounded wait; tiny configs may finish first).
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-c", child_code],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )
    deadline = time.time() + 3000
    while time.time() < deadline:
        if ckpt_path.exists() or proc.poll() is not None:
            break
        time.sleep(0.5)
    preempted = proc.poll() is None
    if preempted:
        proc.send_signal(signal.SIGTERM)
    out1, _ = proc.communicate(timeout=3600)
    timings["clean_first_launch_s"] = round(time.time() - t0, 2)
    timings["preempted"] = bool(preempted)

    if ckpt_path.exists():
        with np.load(ckpt_path) as data:
            timings["checkpoint_cycle"] = int(data["cycle"])

    # Relaunch: must resume and complete.
    t0 = time.time()
    code, out2 = run_clean()
    timings["clean_resume_s"] = round(time.time() - t0, 2)
    assert code == 0 and "CLEAN_DONE" in out2, out2[-2000:]

    model = np.load(outdir / "model.npy")
    residual = np.load(outdir / "residual.npy")
    timings["model_flux"] = float(model.sum())
    timings["residual_peak"] = float(np.abs(residual).max())
    timings["dirty_peak"] = float(np.abs(direct).max())
    assert timings["residual_peak"] < timings["dirty_peak"]

    timings["config"] = (
        "production 10240px" if args.production else "smoke"
    )
    print(json.dumps(timings))


if __name__ == "__main__":
    main()
