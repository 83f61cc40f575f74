"""
Production-SCALE streaming proof: >= 50M visibilities through the UVW
tile store into the 10240-px imaging config on one device.

The reference's production input is a 1-hour MeerKAT MS
(reference: slurm/csd3_icelake.sh:19) — two to three orders of
magnitude more samples than scripts/production_bench.py's capability
probe. This script synthesizes a dataset at that scale, reorders it
into tile chunks (the production data layout), and runs the tiled
sharded invert, reporting sustained Mvis/s, per-stage times (reorder,
tile load, plan, stage, compile, repeat execute), peak host RSS, and
the device memory stats jax exposes. Prints one JSON line.

Usage:
  python scripts/production_scale_bench.py              # full scale
  CIP_SCALE_SMOKE=1 python scripts/production_scale_bench.py  # tiny
"""

import json
import os
import resource
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def main() -> None:
    smoke = os.environ.get("CIP_SCALE_SMOKE") == "1"
    if smoke:
        num_pixels, pixel_asec = 256, 15.0
        num_times, num_antennas, num_channels = 4, 16, 4
        tile_size = (3000.0, 3000.0, 6000.0)
    else:
        num_pixels, pixel_asec = 10240, 1.1
        # 60 x 8128 baselines x 103 channels = 50.2M samples
        num_times, num_antennas, num_channels = 60, 128, 103
        tile_size = (30000.0, 30000.0, 60000.0)

    import jax

    from ska_sdp_cip_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()

    from ska_sdp_cip_tpu.invert import pixel_size_lm_from_asec
    from ska_sdp_cip_tpu.io.synth import make_synthetic_dataset
    from ska_sdp_cip_tpu.io.visibility_dataset import VisibilityReader
    from ska_sdp_cip_tpu.parallel.mesh import make_device_mesh
    from ska_sdp_cip_tpu.uvw_tiling import reorder_by_uvw_tile
    from ska_sdp_cip_tpu.uvw_tiling.tiled_invert import (
        sharded_invert_tile_chunks,
    )

    import tempfile

    report = {}
    with tempfile.TemporaryDirectory(dir="/tmp") as tmp:
        out = Path(tmp)
        # Arena prewarm at process start: the bench VM's fault rate
        # collapses once RSS grows (utils/hostmem.py), so the
        # planner's scratch pages are faulted NOW, at the fresh
        # process's 2-3 GB/s, instead of mid-pipeline at ~130 MB/s.
        t0 = time.time()
        from ska_sdp_cip_tpu.ops.plan import prewarm_plan_arenas

        prewarm_plan_arenas(
            num_times * num_antennas * (num_antennas - 1) // 2
            * num_channels
        )
        report["prewarm_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        dataset = make_synthetic_dataset(
            out / "obs.vz",
            num_times=num_times,
            num_antennas=num_antennas,
            channel_frequencies=np.linspace(
                1.40e9, 1.507e9, num_channels
            ),
            seed=99,
        )
        reader = VisibilityReader(dataset)
        num_vis = reader.num_data_rows * reader.num_channels
        report["num_vis"] = int(num_vis)
        report["synthesize_s"] = round(time.time() - t0, 1)

        t0 = time.time()
        tiles_dir = out / "tiles"
        tiles_dir.mkdir()
        reorder_by_uvw_tile(
            reader, tile_size, tiles_dir, max_vis_per_chunk=5_000_000
        )
        chunks = sorted(tiles_dir.glob("tile_iu*chunk*.npz"))
        report["reorder_s"] = round(time.time() - t0, 1)
        report["tile_chunks"] = len(chunks)
        report["tile_bytes"] = int(
            sum(p.stat().st_size for p in chunks)
        )

        timings = {}
        image = sharded_invert_tile_chunks(
            chunks,
            reader.channel_frequencies(),
            num_pixels,
            pixel_size_lm_from_asec(pixel_asec),
            mesh=make_device_mesh(),
            timings=timings,
            repeats=3,
        )
        report.update(timings)
        report["image_abs_max"] = float(np.abs(image).max())
        report["finite"] = bool(np.isfinite(image).all())
        exec_s = timings.get(
            "execute_s", timings.get("compile_first_s")
        )
        report["sustained_mvis_per_s"] = round(
            num_vis / exec_s / 1e6, 2
        )
        report["peak_host_rss_gb"] = round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2
        )
        try:
            stats = jax.devices()[0].memory_stats() or {}
            report["device_peak_bytes"] = int(
                stats.get("peak_bytes_in_use", 0)
            )
        except Exception:
            report["device_peak_bytes"] = None
        report["device"] = str(jax.devices()[0])

    print(json.dumps(report))
    if not report["finite"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
