"""
Measurement operator: the forward/adjoint pair at the heart of imaging
as regularized linear least squares.

The reference stops at the dirty image (adjoint only, via ducc0
ms2dirty — reference: src/ska_sdp_cip/invert.py:152-184); this module
packages the gridder's invert/predict pair as a linear operator so
major-cycle solvers run entirely on device:

    objective(I) = || sqrt(w) (G I - v) ||^2
    gradient(I)  = G* ( w (G I - v) )          (= invert of residual)

with G = degridding (predict) and G* its exact adjoint (invert).
Visibilities are carried as split (re, im) float32 pairs — the compute
path is complex-free (see ops/fft.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..ops.gridder import (
    build_invert,
    build_predict,
    plan_device_arrays,
    slot_duplicate_pairs,
    slot_group_sum,
    split_complex,
    stage_slot_vis,
    stage_slot_weights,
)
from ..ops.plan import GridderPlan, make_plan


class SlotVis(NamedTuple):
    """
    Visibilities staged in gridder slot order (``stage_slot_vis``
    convention): the form the hot invert/predict programs consume with
    no on-device gather. Produced once by
    :meth:`MeasurementOperator.stage`; every solver iteration reuses it.
    """

    re: jnp.ndarray
    im: jnp.ndarray


def as_split_pair(vis) -> tuple:
    """
    Normalize a visibility argument — complex array or (re, im) pair —
    to flattened float32 jnp arrays.
    """
    if isinstance(vis, tuple):
        re, im = vis
        return (
            jnp.asarray(re, jnp.float32).ravel(),
            jnp.asarray(im, jnp.float32).ravel(),
        )
    re, im = split_complex(np.asarray(vis).ravel())
    return jnp.asarray(re), jnp.asarray(im)


@dataclass
class MeasurementOperator:
    """
    Forward (image -> visibilities) and adjoint (visibilities -> image)
    measurement operators for one visibility set at one imaging
    configuration. All heavy methods are jit-compiled closures over a
    static gridding plan; arrays live on device.
    """

    plan: GridderPlan
    arrays: dict = field(repr=False)
    weights: jnp.ndarray = field(repr=False)  # effective weights, (V,)
    #: Effective weights gathered into slot order (padding slots 0).
    slot_weights: jnp.ndarray = field(repr=False, default=None)
    #: Straddler slot pairs sharing one source sample (may be empty).
    dup_a: jnp.ndarray = field(repr=False, default=None)
    dup_b: jnp.ndarray = field(repr=False, default=None)

    @classmethod
    def build(
        cls,
        uvw: np.ndarray,
        channel_frequencies: np.ndarray,
        weights: np.ndarray,
        num_pixels: int,
        pixel_size_lm: float,
        *,
        epsilon: float = 1e-4,
        do_wstacking: bool = True,
        sigma: float | str = 2.0,
    ) -> "MeasurementOperator":
        """Plan and stage a measurement operator for the given geometry."""
        plan = make_plan(
            uvw,
            channel_frequencies,
            num_pixels,
            pixel_size_lm,
            epsilon=epsilon,
            do_wstacking=do_wstacking,
            sigma=sigma,
        )
        weights_flat = np.zeros(plan.num_vis, np.float32)
        raveled = np.asarray(weights, np.float32).ravel()
        weights_flat[: len(raveled)] = raveled
        dup_a, dup_b = slot_duplicate_pairs(plan)
        return cls(
            plan=plan,
            arrays=plan_device_arrays(plan),
            weights=jnp.asarray(weights_flat),
            slot_weights=jnp.asarray(
                stage_slot_weights(plan, raveled)
            ),
            dup_a=jnp.asarray(dup_a),
            dup_b=jnp.asarray(dup_b),
        )

    @cached_property
    def _invert(self):
        return build_invert(self.plan)

    @cached_property
    def _predict(self):
        return build_predict(self.plan)

    @cached_property
    def _invert_slots(self):
        return build_invert(self.plan, slot_input=True)

    @cached_property
    def _predict_slots(self):
        return build_predict(self.plan, slot_output=True)

    @cached_property
    def total_weight(self) -> float:
        return float(jnp.sum(self.weights))

    def stage(self, vis) -> SlotVis:
        """
        Stage measured visibilities into gridder slot order (host-side
        gather + flip + w-shift phase). Do this ONCE per dataset; all
        solver entry points accept the result and skip per-call
        reordering work entirely.
        """
        if isinstance(vis, SlotVis):
            return vis
        if isinstance(vis, tuple):
            re, im = (np.asarray(part).ravel() for part in vis)
        else:
            arr = np.asarray(vis).ravel()
            re, im = arr.real, arr.imag
        slot_re, slot_im = stage_slot_vis(self.plan, re, im)
        return SlotVis(jnp.asarray(slot_re), jnp.asarray(slot_im))

    def forward(self, image) -> tuple:
        """G I: model visibilities (unweighted), split (re, im), (V,)."""
        return self._predict(self.arrays, image)

    def adjoint(self, vis_re, vis_im):
        """G* x for already-weighted split visibilities: raw image."""
        num = self.plan.num_vis

        def _pad(x):
            out = jnp.zeros(num, jnp.float32)
            return out.at[: x.shape[0]].set(x)

        return self._invert(self.arrays, _pad(vis_re), _pad(vis_im))

    def dirty_image(self, vis):
        """Normalized dirty image of measured visibilities."""
        slots = self.stage(vis)
        w = self.slot_weights
        return (
            self._invert_slots(self.arrays, slots.re * w, slots.im * w)
            / self.total_weight
        )

    def psf(self):
        """
        Point-spread function: the dirty image of unit visibilities —
        approximately 1 at the phase centre. Unit data visibilities in
        slot order are just the staged w-shift phase factors (flip
        conjugation fixes im = 0) scaled by the slot weights.
        """
        w = self.slot_weights
        return (
            self._invert_slots(
                self.arrays,
                w * self.arrays["phase_cos"],
                w * self.arrays["phase_sin"],
            )
            / self.total_weight
        )

    def model_slots(self, image) -> SlotVis:
        """
        G I in slot space with straddler pairs group-summed: every slot
        carries its source sample's FULL model value, directly
        comparable to staged data.
        """
        acc_re, acc_im = self._predict_slots(self.arrays, image)
        acc_re, acc_im = slot_group_sum(
            acc_re, acc_im, self.dup_a, self.dup_b
        )
        return SlotVis(acc_re, acc_im)

    def residual_gradient(self, image, vis):
        """
        G* ( w (G I - v) ) / sum(w): the normalized gradient of the
        weighted least-squares objective — one on-device
        predict-residual-regrid round trip (the major cycle's core).
        Runs entirely in slot space: no gather/scatter between the
        predict and the regrid.
        """
        slots = self.stage(vis)
        model = self.model_slots(image)
        w = self.slot_weights
        res_re = (model.re - slots.re) * w
        res_im = (model.im - slots.im) * w
        return (
            self._invert_slots(self.arrays, res_re, res_im)
            / self.total_weight
        )
