"""
chip_smoke.py at tiny sizes on the CPU: its helpers, each phase
function's checks, and its refusal to run without a GPU. The real run
(full widths, on the card) is ``python chip_smoke.py``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from ska_sdp_cip_tpu.io.synth import synthetic_uvw  # noqa: E402
from ska_sdp_cip_tpu.ops.dft import dirty_image_dft  # noqa: E402
from ska_sdp_cip_tpu.utils import compile_cache  # noqa: E402

TINY = chip_smoke.Observation(3, 10, 4, 64, 40.0, 2.0, max_baseline_m=3000.0)
TINY_PRODUCTION = chip_smoke.Observation(
    2, 8, 3, 96, 30.0, 1.5, max_baseline_m=3000.0, seed=11
)


@pytest.fixture
def no_compile_cache(monkeypatch):
    """The CLI points JAX's persistent cache at its directory; keep the
    test process's cache setting untouched."""
    monkeypatch.setattr(
        compile_cache, "configure_compile_cache", lambda: None
    )


def test_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four-cards"]) != 0
    assert capsys.readouterr().out == ""


def test_sample_pixels_brightest_corners_distinct():
    image = np.zeros((32, 32))
    image[7, 20] = -5.0
    pixels = chip_smoke.sample_pixels(image, 20, seed=1)
    assert pixels.shape == (20, 2)
    assert tuple(pixels[0]) == (7, 20)
    corners = {(0, 0), (0, 31), (31, 0), (31, 31)}
    assert corners <= {tuple(p) for p in pixels}
    assert len({tuple(p) for p in pixels}) == 20


@pytest.mark.parametrize("apply_w", [True, False])
def test_sampled_dft_helper_matches_full_dft(apply_w):
    from ska_sdp_cip_tpu.ops.dft import dirty_pixels_dft

    rng = np.random.default_rng(2)
    uvw, _ = synthetic_uvw(3, 8, max_baseline_m=3000.0, seed=4)
    freqs = np.array([1.0e9, 1.1e9])
    shape = (len(uvw), len(freqs))
    vis = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    wgt = rng.uniform(0.5, 2.0, size=shape)
    pix = float(np.sin(np.radians(40.0 / 3600)))
    full = dirty_image_dft(uvw, freqs, vis, wgt, 48, pix, apply_w=apply_w)
    pixels = chip_smoke.sample_pixels(full, 30)
    sampled = dirty_pixels_dft(
        uvw, freqs, vis * wgt, pixels, 48, pix, apply_w=apply_w, chunk=50
    )
    np.testing.assert_allclose(
        sampled, full[pixels[:, 0], pixels[:, 1]],
        atol=1e-12 * np.abs(full).max(),
    )
    if apply_w:
        # The smoke check's metric is zero against the oracle itself.
        assert chip_smoke.sampled_dft_error(
            full, uvw, freqs, vis * wgt, pix, pixels
        ) < 1e-12


def test_adjoint_error_exact_pair():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(5, 4)) + 1j * rng.normal(size=(5, 4))
    image = rng.normal(size=4)
    vis = rng.normal(size=5) + 1j * rng.normal(size=5)
    dirty = np.real(g.conj().T @ vis)
    assert chip_smoke.adjoint_error(image, dirty, g @ image, vis) < 1e-12


def test_count_carry_copies():
    text = "\n".join(
        [
            "  %copy.1 = f32[40,128]{1,0} copy(f32[40,128]{1,0} %p)",
            "  %cs = (f32[40,128]{1,0}, u32[]) copy-start(%x)",
            "  %copy.2 = f32[40,128]{0,1} copy-start(f32[40,128] %q)",
            "  %copy.3 = f32[8,128]{1,0} copy(f32[8,128]{1,0} %r)",
            "  %add = f32[40,128]{1,0} add(%a, %b)",
        ]
    )
    assert chip_smoke.count_carry_copies(text, (40, 128)) == 2


def test_sigma_cost_inputs():
    bench = {
        "ngrid": 64, "nplanes": 3, "num_vis": 1000, "support": 5,
        "seconds": {"invert_warm": 1.0},
    }
    fft = {
        "64": {"four_step_highest": {"warm_seconds": 0.1}},
        "128": {"four_step_highest": {"warm_seconds": 0.4}},
    }
    costs = chip_smoke.sigma_cost_inputs(bench, fft)
    assert costs["fft_per_cell_plane"] == pytest.approx(0.4 / 128**2)
    assert costs["grid_per_vis_plane"] == pytest.approx(0.7 / 5000)


def test_phase_bench_tiny(tmp_path, no_compile_cache):
    result = chip_smoke.phase_bench(tmp_path, TINY)
    assert result["dft_rel_error"] < chip_smoke.DFT_RTOL
    assert result["adjoint_rel_error"] < chip_smoke.ADJOINT_RTOL
    norms = result["residual_norms"]
    assert len(norms) == chip_smoke.CLEAN_CYCLES + 1
    assert all(b < a for a, b in zip(norms, norms[1:]))
    assert (tmp_path / "dirty.restored.npy").is_file()


def test_phase_production_tiny():
    result = chip_smoke.phase_production(TINY_PRODUCTION)
    assert result["dft_rel_error"] < chip_smoke.DFT_RTOL
    assert result["adjoint_rel_error"] < chip_smoke.ADJOINT_RTOL
    assert result["ngrid"] == 144
    assert result["carry_copies_in_invert_hlo"] >= 0


def test_phase_fft_tiny():
    result = chip_smoke.phase_fft(sizes=(48, 60))
    for n in ("48", "60"):
        for impl in ("four_step_highest", "jnp_fft_fft2_complex64"):
            assert result[n][impl]["row_rel_error"] < 1e-5


def test_phase_four_cards_tiny(tmp_path):
    result = chip_smoke.phase_four_cards(tmp_path, TINY, num_devices=4)
    assert set(result["rel_errors"]) == {
        "invert_replicated",
        "invert_distributed",
        "major_cycle_model",
        "major_cycle_residual",
    }
    for err in result["rel_errors"].values():
        assert err < chip_smoke.SHARDED_RTOL
