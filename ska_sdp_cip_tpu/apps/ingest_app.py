"""
Ingest CLI — the ``tpu-cip-ingest`` entry point.

One-shot MSv2 -> VZ conversion (io/ms_ingest.py): casacore stays
strictly at this boundary (SURVEY.md section 2b); everything downstream
reads the native VZ columnar store. The reference has no ingest app —
it reads MSv2 via python-casacore on every worker
(reference: measurement_set.py:19-31); here hosts without casacore
read only VZ, and this converter runs wherever casacore installs.
"""

import argparse
import sys
from pathlib import Path

from .. import __version__


def get_parser() -> argparse.ArgumentParser:
    """Create the CLI parser for the app."""
    parser = argparse.ArgumentParser(
        description=(
            "Convert a MeasurementSet v2 into the native VZ columnar "
            "store (requires python-casacore)"
        ),
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument(
        "ms", type=Path, help="Path to the input MeasurementSet v2"
    )
    parser.add_argument(
        "vz", type=Path, help="Path for the output VZ dataset directory"
    )
    parser.add_argument(
        "--row-block",
        type=int,
        default=1_000_000,
        help="Rows converted per streaming block (bounds memory)",
    )
    return parser


def run_program(cli_args: list) -> None:
    """Run the app; the function called by the tests."""
    args = get_parser().parse_args(cli_args)
    from ..io.ms_ingest import ms_to_vz

    path = ms_to_vz(args.ms, args.vz, row_block=args.row_block)
    print(f"wrote {path}")


def main() -> None:
    """Entry point for the ingest app."""
    run_program(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
