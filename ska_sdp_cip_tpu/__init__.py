"""
ska_sdp_cip_tpu — a JAX continuum imaging framework.

A from-scratch re-design of the SKA SDP continuum imaging pipeline
(reference: ska-sdp-continuum-imaging-pipeline, ``src/ska_sdp_cip``) as
JAX programs compiled by XLA for an accelerator (a GPU):

* visibilities live in a sharded columnar store (``io/``) instead of
  casacore MeasurementSets (ingest from MSv2 is a gated boundary);
* the invert/predict measurement operators (convolutional gridding,
  w-stacking, FFT, kernel correction) are jit-compiled matrix-product
  programs (``ops/``) instead of the C++ ducc0 wgridder;
* distribution is one SPMD program over a ``jax.sharding.Mesh`` with
  ``psum`` grid reductions (``parallel/``) instead of dask task graphs;
* the UVW tile re-ordering stage (``uvw_tiling/``) is vectorized binning
  feeding the tiled gridder, file-compatible with the reference's npz
  tiles (and additionally carries weights);
* a major-cycle deconvolution solver runs fully on device (``models/``).

Public API mirrors the reference package surface
(reference: src/ska_sdp_cip/__init__.py:1-10).
"""

from .utils.hostmem import enable_malloc_reuse

# Large staging buffers must reuse warm pages (see utils/hostmem.py);
# on lazily-faulted VM memory first-touch faults dominate staging.
enable_malloc_reuse()

from ._version import __version__  # noqa: E402
from .invert import invert_dataset, sharded_invert_dataset  # noqa: E402
from .io.visibility_dataset import VisibilityReader  # noqa: E402

# Alias matching the reference's public name (MeasurementSetReader),
# reference: src/ska_sdp_cip/__init__.py:1-10
MeasurementSetReader = VisibilityReader

__all__ = [
    "__version__",
    "VisibilityReader",
    "MeasurementSetReader",
    "invert_dataset",
    "sharded_invert_dataset",
]
