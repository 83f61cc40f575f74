"""
Sharded SPMD invert: the device-mesh replacement for the reference's
dask-distributed invert (reference: src/ska_sdp_cip/invert.py:212-270).

The dataset is partitioned into (row_chunks x freq_chunks) shards with
the same balanced-chunk semantics the reference uses
(measurement_set.py:234-277); one shard per mesh device. Every device
runs the identical gridding program on its shard (plans are padded to
common static shapes), and the per-shard images are reduced with a
single ``lax.psum`` over the mesh — the compiler-scheduled equivalent
of `integrate_weighted_images` running on one dask worker
(invert.py:200-209). Normalization by the global effective weight sum
happens after the reduction.
"""

from __future__ import annotations


import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..invert import StokesIGridderInput, pixel_size_lm_from_asec
from ..io.visibility_dataset import VisibilityReader
from ..ops.gridder import build_invert, plan_host_arrays
from ..ops.plan import make_plan, pad_plans_uniform
from .mesh import make_device_mesh


def _is_replicated(key: str) -> bool:
    """Quadrature rule and FFT factors are geometry-only: replicated."""
    return key.startswith("fft_") or key.startswith("quad_")


def addressable_shard_indices(mesh) -> list:
    """
    Shard indices (positions in ``mesh.devices.flat`` order, which is
    how ``P(axis)`` lays out axis 0 of a stacked array) whose device
    belongs to this process. Multi-host staging loads ONLY these — the
    per-worker data locality the reference gets from dask scheduling
    (reference: invert.py:256-261).
    """
    import jax

    process_index = jax.process_index()
    return [
        index
        for index, device in enumerate(mesh.devices.flat)
        if device.process_index == process_index
    ]


def _allgather_max(values: np.ndarray) -> np.ndarray:
    """Element-wise max of a small host array across processes."""
    import jax

    if jax.process_count() == 1:
        return values
    from jax.experimental import multihost_utils

    return np.max(multihost_utils.process_allgather(values), axis=0)


def _allgather_sum(values: np.ndarray) -> np.ndarray:
    """Element-wise sum of a host array across processes."""
    import jax

    if jax.process_count() == 1:
        return values
    from jax.experimental import multihost_utils

    return np.sum(multihost_utils.process_allgather(values), axis=0)


def shard_chunk_counts(
    num_devices: int, num_channels: int, row_chunks, freq_chunks
) -> tuple[int, int]:
    """
    Resolve (row_chunks, freq_chunks) so their product equals the mesh
    size. Mirrors the reference's defaults — row_chunks=1 and one
    frequency chunk per worker, capped by the channel count
    (reference: invert.py:248-252 as intended; see SURVEY.md Q1/Q2) —
    then fills the remainder onto the row axis.
    """
    if freq_chunks is None:
        freq_chunks = min(num_channels, num_devices)
    if row_chunks is None:
        if num_devices % freq_chunks:
            raise ValueError(
                f"num_devices={num_devices} not divisible by "
                f"freq_chunks={freq_chunks}; pass explicit chunk counts"
            )
        row_chunks = num_devices // freq_chunks
    if row_chunks * freq_chunks != num_devices:
        raise ValueError(
            "row_chunks * freq_chunks must equal the number of mesh "
            f"devices ({row_chunks} * {freq_chunks} != {num_devices})"
        )
    return row_chunks, freq_chunks



class ShardedStaging:
    """
    Staged SPMD inputs for one (dataset, mesh, imaging config).

    ``vis_re``/``vis_im``/``weights`` are staged in SLOT order (the
    gridder's block-slot layout, ``ops.gridder.stage_slot_vis``):
    unweighted phased split visibilities and per-slot effective
    weights, so the on-device programs are gather-free.
    ``dup_a``/``dup_b`` are the per-shard straddler slot pairs
    (padded with out-of-range sentinels) for slot-space model
    group-sums (``ops.gridder.slot_group_sum``).
    """

    def __init__(
        self,
        mesh,
        axis_name,
        plans,
        stacked,
        vis_re,
        vis_im,
        weights,
        total_weight,
        dup_a=None,
        dup_b=None,
    ):
        self.mesh = mesh
        self.axis_name = axis_name
        self.plans = plans
        self.stacked = stacked
        self.vis_re = vis_re
        self.vis_im = vis_im
        self.weights = weights
        self.total_weight = total_weight
        self.dup_a = dup_a
        self.dup_b = dup_b

    def in_specs(self):
        """(arrays, per-shard array...) partition specs."""
        return {
            key: P() if _is_replicated(key) else P(self.axis_name)
            for key in self.stacked
        }


def stage_sharded_inputs(
    reader: VisibilityReader,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    mesh: Mesh | None = None,
    row_chunks: int | None = None,
    freq_chunks: int | None = None,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    weighting: str = "natural",
    robust: float = 0.0,
    step=None,
    sigma: float | str = 2.0,
    common_w_grid: bool = False,
    slot_mode: bool = False,
) -> ShardedStaging:
    """
    Partition, load, plan, and stage a dataset onto a device mesh:
    the shared front half of every sharded operation (invert, major
    cycle). Returns a :class:`ShardedStaging`.

    ``sigma="auto"`` resolves ONE oversampling factor for the whole
    mesh (global visibility count + allgathered w range), since every
    shard must plan the identical grid. ``common_w_grid=True``
    additionally forces every shard onto the GLOBAL w-plane grid
    (allgathered |w| range passed as each plan's ``w_range``) —
    required by the distributed-FFT modes, which sum plane GRIDS
    across shards and need plane p to mean the same w everywhere.
    """
    from contextlib import nullcontext

    if step is None:
        step = lambda name: nullcontext()  # noqa: E731

    if mesh is None:
        mesh = make_device_mesh()
    (axis_name,) = mesh.axis_names
    num_devices = mesh.devices.size

    row_chunks, freq_chunks = shard_chunk_counts(
        num_devices, reader.num_channels, row_chunks, freq_chunks
    )
    pixel_size_lm = pixel_size_lm_from_asec(pixel_size_asec)

    # Every process loads, weights, and plans ONLY the shards its own
    # devices will hold (the reference's per-worker chunk loading,
    # invert.py:256-261); cross-process agreement comes from small
    # allgathers (plan shape maxima, weight density, total weight).
    local_ids = addressable_shard_indices(mesh)
    chunk_readers = reader.partition(row_chunks, freq_chunks)

    with step("load_shards"):
        shards = {
            index: StokesIGridderInput.from_reader(chunk_readers[index])
            for index in local_ids
        }
        if weighting != "natural":
            # Global density fit from per-shard histograms + one sum,
            # so shards see exactly the weights a single-device run
            # would (models/weighting.py) without any host reading the
            # full dataset.
            from ..models.weighting import ImagingWeighter

            weighter = ImagingWeighter(
                num_pixels,
                pixel_size_lm,
                scheme=weighting,
                robust=robust,
            )
            density = np.zeros((num_pixels, num_pixels))
            for shard in shards.values():
                density = weighter.accumulate_density(
                    shard.uvw,
                    shard.channel_frequencies,
                    shard.effective_weights(),
                    density,
                )
            weighter.finalize(_allgather_sum(density))
            for shard in shards.values():
                shard.weights = weighter.apply(
                    shard.uvw,
                    shard.channel_frequencies,
                    shard.effective_weights(),
                )
                shard.flags = np.zeros_like(shard.flags)

    with step("plan_shards"):
        # Shard plans must agree on the block size and w-bin grouping
        # (pad_plans_uniform unifies them into one SPMD program), so
        # derive them from the global per-shard visibility count, not
        # each shard's own.
        from ..ops.plan import auto_block_and_group

        block, bin_group = auto_block_and_group(
            reader.num_data_rows
            * reader.num_channels
            // max(num_devices, 1)
        )
        global_w = None
        if sigma == "auto" or common_w_grid:
            # Allgathered |w| range (each process sees only its own
            # shards' extent).
            from ..ops.plan import w_range

            local_whi = 0.0
            for shard in shards.values():
                _, whi = w_range(
                    shard.uvw, shard.channel_frequencies
                )
                local_whi = max(local_whi, whi)
            global_whi = float(
                _allgather_max(np.asarray([local_whi]))[0]
            )
            local_wlo = min(
                (
                    w_range(s.uvw, s.channel_frequencies)[0]
                    for s in shards.values()
                ),
                default=global_whi,
            )
            global_wlo = -float(
                _allgather_max(np.asarray([-local_wlo]))[0]
            )
            global_w = (global_wlo, global_whi)
        if sigma == "auto":
            from ..ops.plan import nm1_min_of, resolve_sigma

            sigma = resolve_sigma(
                reader.num_data_rows * reader.num_channels,
                num_pixels,
                w_extent=global_w[1] - global_w[0],
                nm1_min=nm1_min_of(num_pixels, pixel_size_lm),
                epsilon=epsilon,
                do_wstacking=do_wstacking,
            )
        local_plans = {
            index: make_plan(
                shard.uvw,
                shard.channel_frequencies,
                num_pixels,
                pixel_size_lm,
                epsilon=epsilon,
                do_wstacking=do_wstacking,
                block=block,
                bin_group=bin_group,
                sigma=sigma,
                w_range=global_w if common_w_grid else None,
            )
            for index, shard in shards.items()
        }

    with step("stage_shards"):
        samples = {
            index: (
                shard.visibilities.ravel(),
                shard.effective_weights().ravel(),
            )
            for index, shard in shards.items()
        }
        return stage_planned_shards(
            mesh, local_plans, samples, slot_mode=slot_mode
        )


def stage_planned_shards(
    mesh: Mesh, local_plans: dict, samples: dict,
    slot_mode: bool = False,
) -> ShardedStaging:
    """
    Stage locally-planned shards onto the mesh: pad plans to globally
    agreed static shapes (one small allgather), build the stacked plan
    arrays and split-complex weighted visibilities as globally-sharded
    arrays whose callbacks serve only this process's shards, and
    allgather the total weight. ``local_plans`` / ``samples`` map shard
    index (position in ``mesh.devices.flat``) to this process's plan
    and its ``(complex visibilities, effective weights)`` samples.

    ``slot_mode=True`` drops the data-order <-> slot-order transform
    columns (order, flip_sign, phase_cos, phase_sin) from the staged
    arrays — consumers whose programs run entirely in slot space
    (invert-only drivers) never read them on device, and they are
    ~16 B/slot of host->device transfer (~1 GB at the 50M-visibility
    production scale). The major-cycle driver (sharded_clean) keeps
    them: its PSF program reads the staged phase factors.
    """
    from ..ops.plan import plan_shape_maxima

    (axis_name,) = mesh.axis_names
    num_devices = mesh.devices.size
    local_ids = sorted(local_plans)
    first = local_ids[0]

    local_maxima = plan_shape_maxima(list(local_plans.values()))
    keys = sorted(local_maxima)
    gathered = _allgather_max(
        np.asarray([local_maxima[key] for key in keys], np.int64)
    )
    maxima = dict(zip(keys, (int(v) for v in gathered)))
    padded = pad_plans_uniform(
        [local_plans[i] for i in local_ids], maxima
    )
    plans = dict(zip(local_ids, padded))

    # Stage inputs as globally-sharded arrays:
    # jax.make_array_from_callback asks each process for its
    # addressable shards only, so the callbacks never touch (and we
    # never built) remote shards' data.
    sharded = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())

    def _global_replicated(value):
        value = np.asarray(value)
        return jax.make_array_from_callback(
            value.shape, replicated, lambda idx: value[idx]
        )

    def _global_sharded(per_shard: dict, tail_shape, dtype):
        shape = (num_devices,) + tuple(tail_shape)

        def callback(idx):
            rows = range(*idx[0].indices(num_devices))
            # A request outside this process's shards is a
            # sharding bug; KeyError loudly.
            data = np.stack([per_shard[row] for row in rows])
            return data[(slice(None),) + tuple(idx[1:])]

        return jax.make_array_from_callback(shape, sharded, callback)

    host_arrays = {
        index: plan_host_arrays(plan, slot_mode=slot_mode)
        for index, plan in plans.items()
    }
    # The image-domain geometry maps are computed inside the jitted
    # gridding programs from the replicated quadrature rule — nothing
    # O(npix^2) is staged or compiled separately here.
    stacked = {}
    for key, example in host_arrays[first].items():
        if _is_replicated(key):
            stacked[key] = _global_replicated(example)
        else:
            stacked[key] = _global_sharded(
                {
                    index: arrays[key]
                    for index, arrays in host_arrays.items()
                },
                example.shape,
                example.dtype,
            )

    num_vis = plans[first].num_vis
    # Slot-order staging (split re/im float32, the compute path is
    # complex-free): gather/flip/phase happen HERE, once per dataset,
    # so the jitted programs never pay the on-device gather.
    from ..ops.gridder import (
        slot_duplicate_pairs,
        stage_slot_vis,
        stage_slot_weights,
    )

    vis_re = {}
    vis_im = {}
    weights = {}
    dups = {}
    local_weight = 0.0
    max_dups = 0
    for index, (vis, effective) in samples.items():
        plan = plans[index]
        effective = np.asarray(effective).ravel().astype(np.float32)
        v = np.asarray(vis).ravel()
        pad = plan.num_vis_data - len(v)
        if pad:
            v = np.concatenate([v, np.zeros(pad, v.dtype)])
            effective = np.concatenate(
                [effective, np.zeros(pad, np.float32)]
            )
        re, im = stage_slot_vis(plan, v.real, v.imag)
        vis_re[index] = re
        vis_im[index] = im
        weights[index] = stage_slot_weights(plan, effective)
        dups[index] = slot_duplicate_pairs(plan)
        max_dups = max(max_dups, len(dups[index][0]))
        local_weight += float(effective.sum())
    total_weight = float(_allgather_sum(np.asarray([local_weight]))[0])
    max_dups = int(_allgather_max(np.asarray([max_dups], np.int64))[0])

    def _padded_dups(which):
        # Out-of-range sentinel: gathers clip (value unused), scatters
        # drop (see ops.gridder.slot_group_sum).
        out = {}
        for index, pair in dups.items():
            arr = np.full(max_dups, num_vis, np.int32)
            arr[: len(pair[which])] = pair[which]
            out[index] = arr
        return out

    return ShardedStaging(
        mesh,
        axis_name,
        list(plans.values()),
        stacked,
        _global_sharded(vis_re, (num_vis,), np.float32),
        _global_sharded(vis_im, (num_vis,), np.float32),
        _global_sharded(weights, (num_vis,), np.float32),
        total_weight,
        dup_a=_global_sharded(_padded_dups(0), (max_dups,), np.int32),
        dup_b=_global_sharded(_padded_dups(1), (max_dups,), np.int32),
    )


def sharded_invert_dataset(
    reader: VisibilityReader,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    mesh: Mesh | None = None,
    row_chunks: int | None = None,
    freq_chunks: int | None = None,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    weighting: str = "natural",
    robust: float = 0.0,
    recorder=None,
    sigma: float | str = 2.0,
    fft_mode: str = "replicated",
) -> np.ndarray:
    """
    Invert a visibility dataset into a normalized Stokes-I dirty image,
    distributed over a device mesh (reference API:
    dask_invert_measurement_set, invert.py:212-270).

    ``recorder`` is an optional utils.task_metrics.TaskRecorder whose
    steps replace the reference's dask task stream tracing.
    ``fft_mode="distributed"`` reduces the partial GRIDS
    (psum_scatter into column slabs) and runs each FFT axis pass
    locally with an all_to_all between them — the SURVEY section 7
    L4 design: per-device FFT FLOPs divide by the mesh size instead
    of every device transforming a full replicated grid; requires
    ngrid and npix divisible by the mesh size. All shards then plan
    on the GLOBAL w-plane grid (``common_w_grid``) so plane p means
    the same w everywhere.
    """
    from contextlib import nullcontext

    if fft_mode not in ("replicated", "distributed"):
        raise ValueError(f"unknown fft_mode {fft_mode!r}")
    distributed = fft_mode == "distributed"

    step = recorder.step if recorder is not None else (
        lambda name: nullcontext()
    )

    staging = stage_sharded_inputs(
        reader,
        num_pixels,
        pixel_size_asec,
        mesh=mesh,
        row_chunks=row_chunks,
        freq_chunks=freq_chunks,
        epsilon=epsilon,
        do_wstacking=do_wstacking,
        weighting=weighting,
        robust=robust,
        step=step,
        sigma=sigma,
        common_w_grid=distributed,
        # Invert-only: the slot-order transform columns are never
        # read on device, so they are not staged.
        slot_mode=True,
    )
    axis_name = staging.axis_name
    invert = build_invert(
        staging.plans[0],
        slot_input=True,
        mesh_axis=axis_name if distributed else None,
        num_shards=staging.mesh.devices.size if distributed else 1,
    )

    def shard_fn(arrays, vre, vim, wgt):
        arrays = {
            key: value if _is_replicated(key) else value[0]
            for key, value in arrays.items()
        }
        image = invert(arrays, vre[0] * wgt[0], vim[0] * wgt[0])
        if distributed:
            # Grids were already reduced (psum_scatter) and the image
            # slabs all_gathered inside the invert.
            return image
        return jax.lax.psum(image, axis_name)

    with step("grid_fft_reduce"):
        spmd = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=staging.mesh,
                in_specs=(
                    staging.in_specs(),
                    P(axis_name),
                    P(axis_name),
                    P(axis_name),
                ),
                out_specs=P(),
                # The gridding scan starts from an unvarying zero grid
                # and mixes in shard-varying data; skip the VMA check.
                check_vma=False,
            )
        )
        image = np.asarray(
            jax.block_until_ready(
                spmd(
                    staging.stacked,
                    staging.vis_re,
                    staging.vis_im,
                    staging.weights,
                )
            )
        )

    return image / staging.total_weight
