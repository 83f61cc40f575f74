"""
Generate the ground-truth fixture for the casacore-free MSv2 reader.

Writes (with python-casacore, default storage managers — the layout
the reference's data uses, reference: measurement_set.py:19-31):

  <outdir>/mini.ms.tar.gz   — a miniature MeasurementSet v2 directory
  <outdir>/mini.ms.golden.json — every needed column, exact values
                                 (base64 npy), for byte-level reader
                                 validation without casacore

The build environment has neither network nor casacore, so the
on-disk casacore table format (table.dat AipsIO serialization,
StandardStMan buckets) cannot be produced or validated there. This
script runs in the CI ``ingest-casacore`` job (or any machine with
python-casacore); check the artifacts into ``tests/data/`` to unlock
native-reader development against real format bytes.

Usage: python scripts/make_ms_fixture.py <outdir>
"""

import base64
import io
import json
import sys
import tarfile
from pathlib import Path

import numpy as np

NUM_ROWS = 24
NUM_CHANNELS = 4


def _b64_npy(array: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(array))
    return base64.b64encode(buf.getvalue()).decode()


def main() -> None:
    outdir = Path(sys.argv[1] if len(sys.argv) > 1 else "ms-fixture")
    outdir.mkdir(parents=True, exist_ok=True)
    ms_path = outdir / "mini.ms"

    from casacore.tables import (
        default_ms,
        makearrcoldesc,
        maketabdesc,
        table,
    )

    rng = np.random.default_rng(77)
    uvw = rng.normal(scale=500.0, size=(NUM_ROWS, 3))
    time_col = 5.0e9 + np.arange(NUM_ROWS, dtype=float)
    data = (
        rng.normal(size=(NUM_ROWS, NUM_CHANNELS, 4))
        + 1j * rng.normal(size=(NUM_ROWS, NUM_CHANNELS, 4))
    ).astype(np.complex64)
    flag = rng.random((NUM_ROWS, NUM_CHANNELS, 4)) < 0.1
    weight = rng.uniform(0.5, 2.0, size=(NUM_ROWS, 4)).astype(
        np.float32
    )
    weight_spectrum = rng.uniform(
        0.5, 2.0, size=(NUM_ROWS, NUM_CHANNELS, 4)
    ).astype(np.float32)
    chan_freq = np.linspace(1.0e9, 1.1e9, NUM_CHANNELS)

    with default_ms(
        str(ms_path),
        maketabdesc(
            [
                makearrcoldesc(
                    "DATA", 0.0 + 0j, shape=[NUM_CHANNELS, 4]
                ),
                makearrcoldesc(
                    "WEIGHT_SPECTRUM", 0.0, shape=[NUM_CHANNELS, 4]
                ),
            ]
        ),
    ) as ms:
        ms.addrows(NUM_ROWS)
        ms.putcol("UVW", uvw)
        ms.putcol("TIME", time_col)
        # casacore column layout is (row, chan, corr) but putcol takes
        # the numpy layout directly.
        ms.putcol("DATA", data)
        ms.putcol("FLAG", flag)
        ms.putcol("WEIGHT", weight)
        ms.putcol("WEIGHT_SPECTRUM", weight_spectrum)

    with table(
        f"{ms_path}::SPECTRAL_WINDOW", readonly=False, ack=False
    ) as spw:
        spw.addrows(1)
        spw.putcell("CHAN_FREQ", 0, chan_freq)
        spw.putcell("NUM_CHAN", 0, NUM_CHANNELS)
    with table(
        f"{ms_path}::POLARIZATION", readonly=False, ack=False
    ) as pol:
        pol.addrows(1)
        pol.putcell("CORR_TYPE", 0, np.array([9, 10, 11, 12]))
        pol.putcell("NUM_CORR", 0, 4)
    with table(f"{ms_path}::FIELD", readonly=False, ack=False) as field:
        field.addrows(1)

    # Golden dumps read back THROUGH casacore (not the arrays above),
    # so storage-manager round-trip quirks are part of the truth.
    # A second variant binding DATA/FLAG/WEIGHT_SPECTRUM to
    # TiledColumnStMan — the layout real observatory MSs use — to
    # validate the native reader's TSM cube decode.
    tsm_path = outdir / "mini_tsm.ms"
    dminfo = {
        "*1": {
            "TYPE": "TiledColumnStMan",
            "NAME": "TiledData",
            "SPEC": {"DEFAULTTILESHAPE": [4, NUM_CHANNELS, 8]},
            "COLUMNS": ["DATA"],
        },
        "*2": {
            "TYPE": "TiledColumnStMan",
            "NAME": "TiledFlag",
            "SPEC": {"DEFAULTTILESHAPE": [4, NUM_CHANNELS, 8]},
            "COLUMNS": ["FLAG"],
        },
    }
    with default_ms(
        str(tsm_path),
        maketabdesc(
            [
                makearrcoldesc(
                    "DATA", 0.0 + 0j, shape=[NUM_CHANNELS, 4]
                ),
                makearrcoldesc(
                    "WEIGHT_SPECTRUM", 0.0, shape=[NUM_CHANNELS, 4]
                ),
            ]
        ),
        dminfo,
    ) as ms:
        ms.addrows(NUM_ROWS)
        ms.putcol("UVW", uvw)
        ms.putcol("TIME", time_col)
        ms.putcol("DATA", data)
        ms.putcol("FLAG", flag)
        ms.putcol("WEIGHT", weight)
        ms.putcol("WEIGHT_SPECTRUM", weight_spectrum)
    with tarfile.open(outdir / "mini_tsm.ms.tar.gz", "w:gz") as tar:
        tar.add(tsm_path, arcname="mini_tsm.ms")

    # A TiledShapeStMan variant: DATA declared variable-shape (no
    # fixed shape in the column desc, ndim=2) bound to TSSM — the
    # manager the CASA filler commonly uses for DATA/FLAG. One cell
    # shape for every row -> single hypercube, the subset TSSMFile
    # decodes (io/casacore_tables.py).
    tssm_path = outdir / "mini_tssm.ms"
    tssm_dminfo = {
        "*1": {
            "TYPE": "TiledShapeStMan",
            "NAME": "TiledShapeData",
            "SPEC": {"DEFAULTTILESHAPE": [4, NUM_CHANNELS, 8]},
            "COLUMNS": ["DATA"],
        },
    }
    with default_ms(
        str(tssm_path),
        maketabdesc(
            [
                makearrcoldesc("DATA", 0.0 + 0j, ndim=2),
            ]
        ),
        tssm_dminfo,
    ) as ms:
        ms.addrows(NUM_ROWS)
        ms.putcol("UVW", uvw)
        ms.putcol("TIME", time_col)
        ms.putcol("DATA", data)
        ms.putcol("FLAG", flag)
        ms.putcol("WEIGHT", weight)
    with tarfile.open(outdir / "mini_tssm.ms.tar.gz", "w:gz") as tar:
        tar.add(tssm_path, arcname="mini_tssm.ms")

    # A third variant binding IncrementalStMan for the slowly-varying
    # scalars (TIME/UVW/WEIGHT), the way CASA-written observatory MSs
    # do — validates the native reader's ISM decode (also check into
    # tests/data/ alongside the others for the local golden test).
    ism_path = outdir / "mini_ism.ms"
    ism_dminfo = {
        "*1": {
            "TYPE": "IncrementalStMan",
            "NAME": "ISMData",
            "SPEC": {},
            "COLUMNS": ["TIME", "UVW", "WEIGHT"],
        },
    }
    with default_ms(
        str(ism_path),
        maketabdesc(
            [
                makearrcoldesc(
                    "DATA", 0.0 + 0j, shape=[NUM_CHANNELS, 4]
                ),
            ]
        ),
        ism_dminfo,
    ) as ms:
        ms.addrows(NUM_ROWS)
        ms.putcol("UVW", uvw)
        ms.putcol("TIME", time_col)
        ms.putcol("DATA", data)
        ms.putcol("FLAG", flag)
        ms.putcol("WEIGHT", weight)
    with tarfile.open(outdir / "mini_ism.ms.tar.gz", "w:gz") as tar:
        tar.add(ism_path, arcname="mini_ism.ms")

    with table(str(ms_path), readonly=True, ack=False) as ms:
        golden = {
            "num_rows": NUM_ROWS,
            "num_channels": NUM_CHANNELS,
            "columns": {
                name: _b64_npy(ms.getcol(name))
                for name in (
                    "UVW",
                    "TIME",
                    "DATA",
                    "FLAG",
                    "WEIGHT",
                    "WEIGHT_SPECTRUM",
                )
            },
            "chan_freq": _b64_npy(chan_freq),
            "corr_type": [9, 10, 11, 12],
        }
    (outdir / "mini.ms.golden.json").write_text(json.dumps(golden))

    with tarfile.open(outdir / "mini.ms.tar.gz", "w:gz") as tar:
        tar.add(ms_path, arcname="mini.ms")
    print(f"fixture written to {outdir}")


if __name__ == "__main__":
    main()
