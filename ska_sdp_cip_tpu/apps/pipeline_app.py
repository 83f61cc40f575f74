"""
Imaging CLI — the ``tpu-cip`` entry point.

Argument-compatible with the reference's ``ska-sdp-cip`` app
(reference: src/ska_sdp_cip/apps/pipeline_app.py:17-116): positional
dataset + output image, ``-n/--num-pixels``, ``-p/--pixel-size``, and a
distribution group. The dask scheduler address is replaced by
``-d/--devices`` (mesh size; "all" = every visible device); distributed
runs write ``task-list.json`` in the reference's schema and optionally
a JAX profiler trace (the replacement for dask's performance_report
HTML).
"""

import argparse
import sys
from pathlib import Path

import numpy as np

from .. import __version__
from ..invert import invert_dataset
from ..io.visibility_dataset import VisibilityReader
from ..utils.task_metrics import TaskRecorder


def get_parser() -> argparse.ArgumentParser:
    """Create the CLI parser for the app."""
    parser = argparse.ArgumentParser(
        description="Launch the JAX SKA continuum imaging pipeline",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument(
        "dataset",
        type=Path,
        help="Path to the input visibility dataset (VZ directory, or "
        "MeasurementSet v2 if python-casacore is installed)",
    )
    parser.add_argument(
        "output_image",
        type=Path,
        help="Path to output image, which is saved as a numpy array",
    )

    imaging_group = parser.add_argument_group("imaging")
    imaging_group.add_argument(
        "-n",
        "--num-pixels",
        type=int,
        required=True,
        help="Number of pixels across the image",
    )
    imaging_group.add_argument(
        "-p",
        "--pixel-size",
        type=float,
        required=True,
        help="Pixel size in arcseconds at the image centre",
    )
    imaging_group.add_argument(
        "-e",
        "--epsilon",
        type=float,
        default=1e-4,
        help="Gridding accuracy target",
    )
    imaging_group.add_argument(
        "--no-wstacking",
        action="store_true",
        help="Disable w-stacking (narrow-field imaging)",
    )
    imaging_group.add_argument(
        "--sigma",
        type=str,
        default="auto",
        help='uv-grid oversampling factor (e.g. 2.0, 1.5), or "auto": '
        "cost-model choice — FFT-dominated wide fields get 1.5 (44%% "
        "smaller padded grid per w-plane), visibility-dominated runs "
        "keep 2.0",
    )
    imaging_group.add_argument(
        "--weighting",
        choices=["natural", "uniform", "robust"],
        default="natural",
        help="Imaging weighting scheme",
    )
    imaging_group.add_argument(
        "--robust",
        type=float,
        default=0.0,
        help="Briggs robustness parameter (with --weighting robust)",
    )

    clean_group = parser.add_argument_group("deconvolution")
    clean_group.add_argument(
        "--clean",
        type=int,
        default=0,
        metavar="N",
        help="Run N CLEAN major cycles after the dirty image; writes "
        "<output>.model.npy and <output>.residual.npy",
    )
    clean_group.add_argument(
        "--algorithm",
        choices=["hogbom", "multiscale", "fista"],
        default="hogbom",
        help="Deconvolution algorithm for --clean (single-device and "
        "distributed -d runs)",
    )
    clean_group.add_argument(
        "--scales",
        type=float,
        nargs="+",
        default=[0.0, 2.0, 4.0, 8.0],
        help="Scale sizes in pixels (with --algorithm multiscale)",
    )
    clean_group.add_argument(
        "--gain",
        type=float,
        default=0.1,
        help="CLEAN loop gain",
    )
    clean_group.add_argument(
        "--minor-iter",
        type=int,
        default=100,
        help="Hogbom iterations per major cycle",
    )
    clean_group.add_argument(
        "--checkpoint-dir",
        type=Path,
        default=None,
        help="Checkpoint/resume directory for the major cycle",
    )

    dist_group = parser.add_argument_group("distribution")
    dist_group.add_argument(
        "-d",
        "--devices",
        type=str,
        default=None,
        help="Distribute over a device mesh: an integer device count, "
        "or 'all' for every visible device. Default: single device.",
    )
    dist_group.add_argument(
        "-rc",
        "--row-chunks",
        type=int,
        default=None,
        help="Number of row chunks (shards) along the row axis",
    )
    dist_group.add_argument(
        "-fc",
        "--freq-chunks",
        type=int,
        default=None,
        help="Number of frequency chunks. If None, set to "
        "min(num_channels, num_devices).",
    )
    dist_group.add_argument(
        "--profile-dir",
        type=Path,
        default=None,
        help="Write a JAX profiler trace for the run to this directory",
    )
    return parser


def run_program(cli_args: list[str]) -> None:
    """Run the app; the function called by the tests."""
    args = get_parser().parse_args(cli_args)
    reader = VisibilityReader(args.dataset)
    sigma = args.sigma if args.sigma == "auto" else float(args.sigma)

    # Pre-fault the host allocation arenas for the planner: on VM
    # hosts whose fault rate collapses under memory pressure
    # (utils/hostmem.py) this moves the cold-fault cost to startup.
    from ..ops.plan import prewarm_plan_arenas

    prewarm_plan_arenas(reader.num_data_rows * reader.num_channels)

    profile_ctx = None
    if args.profile_dir is not None:
        import jax

        profile_ctx = jax.profiler.trace(str(args.profile_dir))
        profile_ctx.__enter__()

    try:
        if args.devices is None:
            image = invert_dataset(
                reader,
                num_pixels=args.num_pixels,
                pixel_size_asec=args.pixel_size,
                epsilon=args.epsilon,
                do_wstacking=not args.no_wstacking,
                weighting=args.weighting,
                robust=args.robust,
                sigma=sigma,
            )
        else:
            from ..parallel.mesh import make_device_mesh
            from ..parallel.sharded_invert import sharded_invert_dataset

            num_devices = (
                None if args.devices == "all" else int(args.devices)
            )
            mesh = make_device_mesh(num_devices)
            recorder = TaskRecorder()
            image = sharded_invert_dataset(
                reader,
                num_pixels=args.num_pixels,
                pixel_size_asec=args.pixel_size,
                mesh=mesh,
                row_chunks=args.row_chunks,
                freq_chunks=args.freq_chunks,
                epsilon=args.epsilon,
                do_wstacking=not args.no_wstacking,
                weighting=args.weighting,
                robust=args.robust,
                recorder=recorder,
                sigma=sigma,
            )
            # Same file name / schema as the reference
            # (reference: apps/pipeline_app.py:105-107).
            recorder.save_json("task-list.json", indent=4, sort_keys=True)
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)

    np.save(args.output_image.with_suffix(".npy"), image)

    if args.clean > 0:
        from ..models.restore import restore_image

        if args.devices is not None:
            # Distributed major cycle over the same mesh shape; the
            # PSF comes from the sharded program itself, so no
            # single-device operator over the full dataset is built.
            from ..parallel.mesh import make_device_mesh
            from ..parallel.sharded_clean import (
                sharded_major_cycle_clean,
            )

            num_devices = (
                None if args.devices == "all" else int(args.devices)
            )
            model, residual, psf = sharded_major_cycle_clean(
                reader,
                args.num_pixels,
                args.pixel_size,
                mesh=make_device_mesh(num_devices),
                row_chunks=args.row_chunks,
                freq_chunks=args.freq_chunks,
                epsilon=args.epsilon,
                do_wstacking=not args.no_wstacking,
                weighting=args.weighting,
                robust=args.robust,
                num_major=args.clean,
                gain=args.gain,
                minor_iter=args.minor_iter,
                algorithm=args.algorithm,
                scales=tuple(args.scales),
                sigma=sigma,
                checkpoint_dir=args.checkpoint_dir,
            )
        else:
            from ..invert import (
                StokesIGridderInput,
                pixel_size_lm_from_asec,
            )
            from ..models import (
                MeasurementOperator,
                major_cycle_clean,
            )

            gridder_input = StokesIGridderInput.from_reader(reader)
            weights = gridder_input.effective_weights()
            if args.weighting != "natural":
                # The model/residual must be consistent with the
                # weighting used for the dirty image above.
                from ..models.weighting import ImagingWeighter

                weighter = ImagingWeighter(
                    args.num_pixels,
                    pixel_size_lm_from_asec(args.pixel_size),
                    scheme=args.weighting,
                    robust=args.robust,
                ).fit(
                    gridder_input.uvw,
                    gridder_input.channel_frequencies,
                    weights,
                )
                weights = weighter.apply(
                    gridder_input.uvw,
                    gridder_input.channel_frequencies,
                    weights,
                )
            operator = MeasurementOperator.build(
                gridder_input.uvw,
                gridder_input.channel_frequencies,
                weights,
                args.num_pixels,
                pixel_size_lm_from_asec(args.pixel_size),
                epsilon=args.epsilon,
                do_wstacking=not args.no_wstacking,
                sigma=sigma,
            )
            if args.algorithm == "multiscale":
                from ..models.multiscale import multiscale_clean

                model, residual = multiscale_clean(
                    operator,
                    gridder_input.visibilities.ravel(),
                    scales=tuple(args.scales),
                    num_major=args.clean,
                    gain=args.gain,
                    minor_iter=args.minor_iter,
                )
            elif args.algorithm == "fista":
                from ..models.fista import fista_clean

                model, residual, _ = fista_clean(
                    operator,
                    gridder_input.visibilities.ravel(),
                    num_iter=args.clean * args.minor_iter // 10,
                )
            else:
                model, residual = major_cycle_clean(
                    operator,
                    gridder_input.visibilities.ravel(),
                    num_major=args.clean,
                    gain=args.gain,
                    minor_iter=args.minor_iter,
                    checkpoint_dir=args.checkpoint_dir,
                )
            psf = np.asarray(operator.psf())
        base = args.output_image.with_suffix("")
        np.save(base.with_suffix(".model.npy"), np.asarray(model))
        np.save(base.with_suffix(".residual.npy"), np.asarray(residual))
        restored = restore_image(model, residual, np.asarray(psf))
        np.save(base.with_suffix(".restored.npy"), restored)


def main() -> None:
    """Entry point for the pipeline app."""
    from ..utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    run_program(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
