"""
Host allocator tuning for large staging buffers.

The planning/staging path allocates many large (tens-to-hundreds of MB)
short-lived host arrays. glibc serves allocations above the mmap
threshold with fresh mmap'd pages and returns them to the kernel on
free, so every temporary pays first-touch page faults again — on
virtualized hosts with lazily-faulted memory (as in cloud VMs) that
can slow host staging by orders of magnitude against warm pages.

``enable_malloc_reuse`` switches glibc to keep large blocks in the
arena (``M_MMAP_MAX=0``) and never trim freed memory back to the OS
(``M_TRIM_THRESHOLD=-1``), so page faults are paid once per high-water
mark instead of once per allocation. Called on package import; opt out
with ``CIP_MALLOC_REUSE=0`` (the process will hold its peak host
memory footprint for its lifetime — the right trade for a pipeline
process, not necessarily for a shared notebook kernel).

The reference leaves this to dask worker processes whose arenas stay
warm across tasks (reference: src/ska_sdp_cip/invert.py:256-268); a
single-process SPMD driver must arrange it explicitly.
"""

from __future__ import annotations

import ctypes
import mmap as _mmap
import os

import numpy as np

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4

_enabled: bool | None = None


def enable_malloc_reuse() -> bool:
    """
    Configure glibc malloc to retain and reuse large freed blocks.
    Returns True when active (idempotent; False on non-glibc platforms
    or when disabled via ``CIP_MALLOC_REUSE=0``).
    """
    global _enabled
    if _enabled is not None:
        return _enabled
    if os.environ.get("CIP_MALLOC_REUSE", "1") != "1":
        _enabled = False
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok_mmap = libc.mallopt(_M_MMAP_MAX, 0)
        ok_trim = libc.mallopt(_M_TRIM_THRESHOLD, -1)
        _enabled = bool(ok_mmap and ok_trim)
    except Exception:
        _enabled = False
    return _enabled


#: Concurrent fault streams for :func:`alloc_populated`. Faults are
#: hypervisor-bound, not CPU-bound: 8-16 streams sustain 2-3 GB/s on
#: the 2-core bench VM where a single stream collapses to ~80 MB/s
#: under memory pressure.
_TOUCH_WORKERS = 8
_touch_pool = None


def _get_touch_pool():
    global _touch_pool
    if _touch_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _touch_pool = ThreadPoolExecutor(_TOUCH_WORKERS)
    return _touch_pool


#: Arena of already-faulted buffers, keyed by power-of-two bucket
#: size. The hypervisor's fault rate COLLAPSES (to tens of MB/s) once
#: process RSS crosses ~1 GB on the bench VM, and stays collapsed —
#: while writes to already-faulted pages keep running at GB/s. Reusing
#: freed buffers therefore pays the fault cost once per high-water
#: mark instead of once per allocation (the same rationale as
#: enable_malloc_reuse, applied to these mmap-backed buffers).
#: Buffers return to the arena when their numpy array (and every view
#: of it) is garbage-collected. Disable with CIP_HOST_ARENA=0.
_arena: dict = {}
_arena_lock = None


def _arena_enabled() -> bool:
    return os.environ.get("CIP_HOST_ARENA", "1") == "1"


def _get_arena_lock():
    global _arena_lock
    if _arena_lock is None:
        import threading

        _arena_lock = threading.Lock()
    return _arena_lock


def _arena_release(buf, bucket: int) -> None:
    with _get_arena_lock():
        _arena.setdefault(bucket, []).append(buf)


def alloc_populated(count: int, dtype) -> np.ndarray:
    """
    A fresh 1-D numpy array of ``count`` elements backed by
    pre-faulted anonymous memory, faulted by CONCURRENT touch threads
    — or served ZEROED from the warm-buffer arena when a freed buffer
    of the right bucket exists (no faults at all).

    ``np.empty`` maps pages lazily; on hosts with lazily-backed VM
    memory, serial first-touch faults are erratically slow — and so is
    ``MAP_POPULATE`` (kernel-side but serial). One 4096-stride touch
    per page from a small thread pool keeps 8 fault streams in flight
    (faults resolve in the hypervisor concurrently; the GIL is
    released on entry to the kernel). Contents are zeroed (fresh
    kernel pages; the touch writes zeros). A warm arena buffer needs
    no faults at all once a process has planned before.
    """
    import weakref

    nbytes = int(count) * np.dtype(dtype).itemsize
    if nbytes < 1 << 20:
        return np.empty(int(count), dtype)
    bucket = 1 << (nbytes - 1).bit_length()
    pool = _get_touch_pool()
    if _arena_enabled():
        with _get_arena_lock():
            free = _arena.get(bucket)
            buf = free.pop() if free else None
        if buf is not None:
            arr = np.frombuffer(buf, dtype=dtype, count=int(count))
            arr.flags.writeable = True
            # Zero the handed-out range (callers rely on zero fill);
            # warm pages take this at memory bandwidth.
            zv = np.frombuffer(buf, dtype=np.uint8, count=nbytes)
            zv.flags.writeable = True
            chunk = -(-nbytes // _TOUCH_WORKERS)

            def _zero(start):
                zv[start : start + chunk] = 0

            list(pool.map(_zero, range(0, nbytes, chunk)))
            weakref.finalize(arr, _arena_release, buf, bucket)
            return arr
    try:
        buf = _mmap.mmap(
            -1, bucket, flags=_mmap.MAP_PRIVATE | _mmap.MAP_ANONYMOUS
        )
    except (AttributeError, OSError, ValueError):
        return np.empty(int(count), dtype)
    arr = np.frombuffer(buf, dtype=dtype, count=int(count))
    arr.flags.writeable = True
    touch = np.frombuffer(buf, dtype=np.uint8)
    touch.flags.writeable = True
    # Fault only the REQUESTED bytes (the pow-of-two bucket can be
    # ~2x the request; cold faults are the rationed resource). A
    # later larger reuse of this bucket faults the tail in its
    # zeroing pass.
    chunk = -(-nbytes // (2 * _TOUCH_WORKERS))
    starts = range(0, nbytes, chunk)

    def _touch(start):
        touch[start : start + chunk : _mmap.PAGESIZE] = 0

    list(pool.map(_touch, starts))
    if _arena_enabled():
        weakref.finalize(arr, _arena_release, buf, bucket)
    return arr
