"""
End-to-end production-flow rehearsal (reference flow:
slurm/csd3_icelake.sh:19-26 + the tiled-gridder north star): synth ->
UVW reorder -> tiled sharded invert (== direct invert) -> distributed
CLEAN with a mid-run SIGTERM and checkpoint resume. Runs the same
script the chip rehearsal uses (scripts/production_rehearsal.py),
CPU-mesh-sized.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

SCRIPT = (
    Path(__file__).parent.parent / "scripts" / "production_rehearsal.py"
)


def test_production_rehearsal_smoke(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    proc = subprocess.run(
        [sys.executable, str(SCRIPT), "--outdir", str(tmp_path / "out")],
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["tile_chunks"] > 0
    assert report["tiled_vs_direct_rel"] < 1e-3
    assert report["residual_peak"] < report["dirty_peak"]
    # The preemption path must actually have exercised resume: either
    # the run was SIGTERM'd mid-flight or at least one cycle had
    # checkpointed before the signal landed.
    assert report["preempted"] or report.get("checkpoint_cycle", 0) > 0
    assert report.get("checkpoint_cycle", 0) >= 1
