"""
Driver entry points stay healthy: entry() compiles and runs, and
dryrun_multichip executes one sharded training step on the 8-device
CPU mesh.
"""

import sys


def test_entry_runs():
    sys.path.insert(0, ".")
    import __graft_entry__ as graft

    fn, args = graft.entry()
    out = fn(*args)
    assert out.shape == (128, 128)
    assert float(abs(out).max()) > 0


def test_dryrun_multichip():
    sys.path.insert(0, ".")
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)


def test_dryrun_multichip_refuses_too_few_devices():
    """The dry run takes devices from one platform and never falls
    back to another one when that platform has too few."""
    import pytest

    sys.path.insert(0, ".")
    import __graft_entry__ as graft

    with pytest.raises(RuntimeError, match="need 64 cpu devices"):
        graft.dryrun_multichip(64)
    with pytest.raises(RuntimeError, match="need 16 cpu devices"):
        graft.dryrun_multichip(16, platform="cpu")
