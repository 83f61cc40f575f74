"""
ctypes bindings for the native C++ planning engine (native/cip_native.cpp).

Loaded lazily; every entry point has a numpy fallback in ops/plan.py,
so the framework runs without the shared library (e.g. before
``make -C native``). pybind11 is deliberately not used — the C ABI +
ctypes keeps the boundary dependency-free.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .utils.hostmem import alloc_populated

_LIB = None
_SEARCHED = False

_LIB_LOCATIONS = (
    Path(__file__).resolve().parent.parent / "native" / "libcipnative.so",
    Path(__file__).resolve().parent / "libcipnative.so",
)


def load_library():
    """The native library, or None when unavailable."""
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    for location in _LIB_LOCATIONS:
        if location.is_file():
            try:
                _LIB = ctypes.CDLL(str(location))
                break
            except OSError:
                continue
    if _LIB is not None:
        _declare(_LIB)
    return _LIB


def available() -> bool:
    return load_library() is not None


def _declare(lib) -> None:
    import ctypes as ct

    dp = ct.POINTER(ct.c_double)
    fp = ct.POINTER(ct.c_float)
    i64p = ct.POINTER(ct.c_int64)
    i32p = ct.POINTER(ct.c_int32)
    u8p = ct.POINTER(ct.c_uint8)

    lib.cip_w_minmax.argtypes = [dp, ct.c_int64, dp, ct.c_int64, dp, dp]
    lib.cip_plan_arrays.argtypes = [
        dp, ct.c_int64, dp, ct.c_int64, ct.c_double, ct.c_int64,
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int,
        ct.c_double, ct.c_double, ct.c_int64,
        u8p, i32p, i32p, fp, fp, fp, i64p,
    ]
    lib.cip_argsort_i64.argtypes = [i64p, ct.c_int64, i64p]
    lib.cip_gather_f32.argtypes = [fp, i64p, ct.c_int64, fp]
    lib.cip_gather_i32.argtypes = [i32p, i64p, ct.c_int64, i32p]
    lib.cip_gather_u8.argtypes = [u8p, i64p, ct.c_int64, u8p]
    lib.cip_slot_plan_build.argtypes = [
        dp, ct.c_int64, dp, ct.c_int64, ct.c_double, ct.c_int64,
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int,
        ct.c_double, ct.c_double, ct.c_int64, ct.c_int64, ct.c_int64,
        ct.c_int,
    ]
    lib.cip_slot_plan_build.restype = ct.c_int64
    lib.cip_slot_plan_sizes.argtypes = [ct.c_int64, i64p]
    lib.cip_slot_plan_export.argtypes = [
        ct.c_int64, ct.c_int64, ct.c_int32,
        i32p, u8p, i32p, i32p, fp, fp, fp,
        i32p, i32p, i32p, i32p, i32p,
        fp, ct.c_double, fp, fp, i32p,
    ]
    lib.cip_slot_plan_free.argtypes = [ct.c_int64]
    lib.cip_arena_prewarm.argtypes = [i64p, ct.c_int64]
    lib.cip_phase_cossin.argtypes = [
        fp, ct.c_int64, ct.c_double, fp, fp
    ]
    lib.cip_density_accumulate.argtypes = [
        dp, ct.c_int64, dp, ct.c_int64, dp, ct.c_double, ct.c_int64, dp
    ]
    lib.cip_stage_slot_vis.argtypes = [
        fp, fp, ct.c_int64, i64p, fp, fp, fp, ct.c_int64,
        ct.c_int32, fp, fp,
    ]


def _ptr(arr, ctype):
    if arr is None:  # optional output: the C side skips NULL targets
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def w_minmax(uvw: np.ndarray, freqs: np.ndarray) -> tuple:
    lib = load_library()
    uvw = np.ascontiguousarray(uvw, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    lo = ctypes.c_double()
    hi = ctypes.c_double()
    lib.cip_w_minmax(
        _ptr(uvw, ctypes.c_double),
        len(uvw),
        _ptr(freqs, ctypes.c_double),
        len(freqs),
        ctypes.byref(lo),
        ctypes.byref(hi),
    )
    return lo.value, hi.value


def plan_arrays(
    uvw: np.ndarray,
    freqs: np.ndarray,
    *,
    inv_du: float,
    ngrid: int,
    support: int,
    tile_cells_x: int,
    tile_cells_y: int,
    ntiles_y: int,
    wstacking: bool,
    w0_plane: float,
    dw: float,
    nplanes: int,
) -> dict:
    """Fused per-sample plan arrays + composite sort key."""
    lib = load_library()
    uvw = np.ascontiguousarray(uvw, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    n = len(uvw) * len(freqs)
    out = {
        "flip": np.empty(n, np.uint8),
        "x0": np.empty(n, np.int32),
        "y0": np.empty(n, np.int32),
        "fx": np.empty(n, np.float32),
        "fy": np.empty(n, np.float32),
        "ws": np.empty(n, np.float32),
        "key": np.empty(n, np.int64),
    }
    lib.cip_plan_arrays(
        _ptr(uvw, ctypes.c_double),
        len(uvw),
        _ptr(freqs, ctypes.c_double),
        len(freqs),
        ctypes.c_double(inv_du),
        ngrid,
        support,
        tile_cells_x,
        tile_cells_y,
        ntiles_y,
        int(wstacking),
        ctypes.c_double(w0_plane),
        ctypes.c_double(1.0 / dw),
        nplanes,
        _ptr(out["flip"], ctypes.c_uint8),
        _ptr(out["x0"], ctypes.c_int32),
        _ptr(out["y0"], ctypes.c_int32),
        _ptr(out["fx"], ctypes.c_float),
        _ptr(out["fy"], ctypes.c_float),
        _ptr(out["ws"], ctypes.c_float),
        _ptr(out["key"], ctypes.c_int64),
    )
    return out


def build_slot_plan(
    uvw: np.ndarray,
    freqs: np.ndarray,
    *,
    inv_du: float,
    ngrid: int,
    support: int,
    tile_x: int,
    tile_y: int,
    ntiles_y: int,
    wstacking: bool,
    w0_plane: float,
    dw: float,
    num_bins: int,
    block: int,
    bin_group: int = 1,
    min_blocks: int = 1,
    pad_order: int = 0,
    phase_factor: float = 0.0,
    export_slot_transform: bool = True,
) -> dict:
    """
    Fused (uvw, freqs) -> block-slot plan layout: per-slot sample
    indices and footprint columns plus per-block metadata, produced by
    one multithreaded C++ pass (geometry, lane-straddler duplication,
    radix key sort, block split, slot scatter). ``num_blocks`` in the
    result is the REAL block count; arrays are padded to
    ``max(num_blocks, min_blocks, 1)`` blocks.

    ``export_slot_transform=False`` skips the flip_sign / phase_cos /
    phase_sin columns (returned as None) and emits ``order_enc``
    instead (source index, conjugation flip in the sign) — the compact
    staging path (ops/gridder.py:build_assemble) rebuilds them on
    device.
    """
    lib = load_library()
    uvw = np.ascontiguousarray(uvw, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    handle = lib.cip_slot_plan_build(
        _ptr(uvw, ctypes.c_double),
        len(uvw),
        _ptr(freqs, ctypes.c_double),
        len(freqs),
        ctypes.c_double(inv_du),
        ngrid,
        support,
        tile_x,
        tile_y,
        ntiles_y,
        int(wstacking),
        ctypes.c_double(w0_plane),
        ctypes.c_double(1.0 / dw),
        num_bins,
        block,
        max(int(bin_group), 1),
        # Keep the per-sample coordinates for the slot export.
        1,
    )
    try:
        nb = ctypes.c_int64()
        lib.cip_slot_plan_sizes(handle, ctypes.byref(nb))
        num_blocks = int(nb.value)
        padded = max(num_blocks, min_blocks, 1)
        num_slots = padded * block
        # Pre-faulted buffers: np.empty pages fault erratically
        # slowly on lazily-backed VM memory (see utils/hostmem.py).
        def _transform(count):
            return (
                alloc_populated(count, np.float32)
                if export_slot_transform
                else None
            )

        out = {
            "order": alloc_populated(num_slots, np.int32),
            "flip": alloc_populated(num_slots, np.uint8),
            "x0": alloc_populated(num_slots, np.int32),
            "y0": alloc_populated(num_slots, np.int32),
            "fx": alloc_populated(num_slots, np.float32),
            "fy": alloc_populated(num_slots, np.float32),
            "ws": alloc_populated(num_slots, np.float32),
            "block_len": alloc_populated(padded, np.int32),
            "block_ox": alloc_populated(padded, np.int32),
            "block_oy": alloc_populated(padded, np.int32),
            "bin_lo": alloc_populated(padded, np.int32),
            "bin_hi": alloc_populated(padded, np.int32),
            # Derived slot-transform columns, same export pass.
            "flip_sign": _transform(num_slots),
            "phase_cos": _transform(num_slots),
            "phase_sin": _transform(num_slots),
            "order_enc": (
                None
                if export_slot_transform
                else alloc_populated(num_slots, np.int32)
            ),
        }
        lib.cip_slot_plan_export(
            handle,
            padded,
            ctypes.c_int32(pad_order),
            _ptr(out["order"], ctypes.c_int32),
            _ptr(out["flip"], ctypes.c_uint8),
            _ptr(out["x0"], ctypes.c_int32),
            _ptr(out["y0"], ctypes.c_int32),
            _ptr(out["fx"], ctypes.c_float),
            _ptr(out["fy"], ctypes.c_float),
            _ptr(out["ws"], ctypes.c_float),
            _ptr(out["block_len"], ctypes.c_int32),
            _ptr(out["block_ox"], ctypes.c_int32),
            _ptr(out["block_oy"], ctypes.c_int32),
            _ptr(out["bin_lo"], ctypes.c_int32),
            _ptr(out["bin_hi"], ctypes.c_int32),
            _ptr(out["flip_sign"], ctypes.c_float),
            ctypes.c_double(phase_factor),
            _ptr(out["phase_cos"], ctypes.c_float),
            _ptr(out["phase_sin"], ctypes.c_float),
            _ptr(out["order_enc"], ctypes.c_int32),
        )
    finally:
        lib.cip_slot_plan_free(handle)
    out["num_blocks"] = num_blocks
    return out


def arena_prewarm(sizes) -> None:
    """Pre-fault C++ scratch buffers of the given byte sizes into the
    native warm-buffer arena (no-op without the native library)."""
    lib = load_library()
    if lib is None or not len(sizes):
        return
    arr = np.ascontiguousarray(sizes, np.int64)
    lib.cip_arena_prewarm(_ptr(arr, ctypes.c_int64), len(arr))


def phase_cossin(ws: np.ndarray, factor: float) -> tuple:
    """(cos(factor * ws), sin(factor * ws)) as float32, multithreaded."""
    lib = load_library()
    ws = np.ascontiguousarray(ws, np.float32)
    cos_out = alloc_populated(len(ws), np.float32)
    sin_out = alloc_populated(len(ws), np.float32)
    lib.cip_phase_cossin(
        _ptr(ws, ctypes.c_float),
        len(ws),
        ctypes.c_double(factor),
        _ptr(cos_out, ctypes.c_float),
        _ptr(sin_out, ctypes.c_float),
    )
    return cos_out, sin_out


def stage_slot_vis(
    vis_re: np.ndarray,
    vis_im: np.ndarray,
    order: np.ndarray,
    flip_sign: np.ndarray,
    phase_cos: np.ndarray,
    phase_sin: np.ndarray,
    *,
    wstacking: bool,
) -> tuple:
    """
    Fused multithreaded slot staging: gather data-order split
    visibilities into slot order, conjugate-flip, apply the w-shift
    pre-phase (ops/gridder.py:stage_slot_vis semantics: padding slots
    whose ``order`` index is out of range stage as zero).
    """
    lib = load_library()
    vis_re = np.ascontiguousarray(vis_re, np.float32).ravel()
    vis_im = np.ascontiguousarray(vis_im, np.float32).ravel()
    order = np.ascontiguousarray(order, np.int64)
    flip_sign = np.ascontiguousarray(flip_sign, np.float32)
    # Keep converted temporaries referenced for the call's duration.
    phase_cos = np.ascontiguousarray(phase_cos, np.float32)
    phase_sin = np.ascontiguousarray(phase_sin, np.float32)
    num_slots = len(order)
    out_re = alloc_populated(num_slots, np.float32)
    out_im = alloc_populated(num_slots, np.float32)
    lib.cip_stage_slot_vis(
        _ptr(vis_re, ctypes.c_float),
        _ptr(vis_im, ctypes.c_float),
        len(vis_re),
        _ptr(order, ctypes.c_int64),
        _ptr(flip_sign, ctypes.c_float),
        _ptr(phase_cos, ctypes.c_float),
        _ptr(phase_sin, ctypes.c_float),
        num_slots,
        ctypes.c_int32(1 if wstacking else 0),
        _ptr(out_re, ctypes.c_float),
        _ptr(out_im, ctypes.c_float),
    )
    return out_re, out_im


def density_accumulate(
    uvw: np.ndarray,
    freqs: np.ndarray,
    weights: np.ndarray,
    *,
    inv_cell: float,
    npix: int,
    density: np.ndarray,
) -> np.ndarray:
    """
    Accumulate gridded weight density (direct + conjugate mirror) into
    ``density`` (npix, npix) float64 — the multithreaded replacement for
    the per-sample ``np.add.at`` fit in models/weighting.py.
    """
    lib = load_library()
    uvw = np.ascontiguousarray(uvw, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    weights = np.ascontiguousarray(
        np.asarray(weights, np.float64).reshape(len(uvw), len(freqs))
    )
    assert density.dtype == np.float64 and density.flags.c_contiguous
    lib.cip_density_accumulate(
        _ptr(uvw, ctypes.c_double),
        len(uvw),
        _ptr(freqs, ctypes.c_double),
        len(freqs),
        _ptr(weights, ctypes.c_double),
        ctypes.c_double(inv_cell),
        npix,
        _ptr(density, ctypes.c_double),
    )
    return density


def argsort_i64(keys: np.ndarray) -> np.ndarray:
    lib = load_library()
    keys = np.ascontiguousarray(keys, np.int64)
    order = np.empty(len(keys), np.int64)
    lib.cip_argsort_i64(
        _ptr(keys, ctypes.c_int64), len(keys), _ptr(order, ctypes.c_int64)
    )
    return order


def gather(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """out[i] = src[order[i]] via the multithreaded native gather."""
    lib = load_library()
    order = np.ascontiguousarray(order, np.int64)
    src = np.ascontiguousarray(src)
    out = np.empty(len(order), src.dtype)
    n = len(order)
    if src.dtype == np.float32:
        lib.cip_gather_f32(
            _ptr(src, ctypes.c_float),
            _ptr(order, ctypes.c_int64),
            n,
            _ptr(out, ctypes.c_float),
        )
    elif src.dtype == np.int32:
        lib.cip_gather_i32(
            _ptr(src, ctypes.c_int32),
            _ptr(order, ctypes.c_int64),
            n,
            _ptr(out, ctypes.c_int32),
        )
    elif src.dtype == np.uint8:
        lib.cip_gather_u8(
            _ptr(src, ctypes.c_uint8),
            _ptr(order, ctypes.c_int64),
            n,
            _ptr(out, ctypes.c_uint8),
        )
    else:
        out = src[order]
    return out
