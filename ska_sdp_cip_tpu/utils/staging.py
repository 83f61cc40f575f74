"""
Parallel host->device staging.

A dict of ~25 plan arrays issued serially pays each transfer's latency
in turn. Staging therefore goes wide: every array is submitted to a
small thread pool, and large arrays are additionally split into ~16 MB
contiguous chunks that transfer concurrently and are reassembled by a
single on-device concatenate. Whether this beats plain ``device_put``
on the H100 host is not measured.

The reference's analog is dask's worker-to-worker data movement, which
it inherits from the cluster rather than arranging explicitly
(reference: src/ska_sdp_cip/invert.py:200-270).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Target chunk size for splitting large transfers into concurrent
#: streams.
CHUNK_BYTES = 16 * 1024 * 1024

#: Pool width: room for 4 bulk streams plus a couple of small-array
#: transfers alongside them.
MAX_WORKERS = 6


def _submit_array(pool: ThreadPoolExecutor, value: np.ndarray):
    """
    Submit one array's transfer; returns ``assemble() -> jax.Array``.
    Large arrays are raveled (zero-copy for contiguous inputs), split
    into CHUNK_BYTES pieces transferred concurrently, and reassembled
    on device with a concatenate + reshape.
    """
    import jax.numpy as jnp

    value = np.ascontiguousarray(value)
    if value.nbytes <= CHUNK_BYTES + CHUNK_BYTES // 2:
        fut = pool.submit(jnp.asarray, value)
        return fut.result

    flat = value.reshape(-1)
    per = max(1, CHUNK_BYTES // value.dtype.itemsize)
    futs = [
        pool.submit(jnp.asarray, flat[start : start + per])
        for start in range(0, flat.size, per)
    ]
    shape = value.shape

    def assemble():
        parts = [f.result() for f in futs]
        return jnp.concatenate(parts).reshape(shape)

    return assemble


def device_put_parallel(host: dict, *, wait: bool = False) -> dict:
    """
    Transfer a dict of host numpy arrays to the default device using
    concurrent chunked streams. With ``wait=True``, blocks until every
    transfer has completed (timing-honest staging); otherwise returns
    as soon as all transfers are dispatched (device ops may be queued
    behind them).
    """
    import jax

    with ThreadPoolExecutor(MAX_WORKERS) as pool:
        assemblers = {
            key: _submit_array(pool, np.asarray(value))
            for key, value in host.items()
        }
        arrays = {key: fn() for key, fn in assemblers.items()}
    if wait:
        for value in arrays.values():
            jax.block_until_ready(value)
    return arrays


class AsyncStager:
    """
    Pipelined staging: submit arrays as they become available on the
    host (each call returns immediately; transfers run on pool
    threads), keep doing host work, then ``result(key)`` /
    ``wait_all()`` to collect. Use as a context manager so the pool
    always shuts down.
    """

    def __init__(self, max_workers: int = MAX_WORKERS):
        self._pool = ThreadPoolExecutor(max_workers)
        self._assemblers: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True)
        return False

    def submit(self, key: str, value: np.ndarray) -> None:
        self._assemblers[key] = _submit_array(
            self._pool, np.asarray(value)
        )

    def submit_dict(self, host: dict) -> None:
        for key, value in host.items():
            self.submit(key, value)

    def result(self, key: str):
        return self._assemblers[key]()

    def wait_all(self) -> dict:
        import jax

        arrays = {
            key: fn() for key, fn in self._assemblers.items()
        }
        for value in arrays.values():
            jax.block_until_ready(value)
        return arrays
