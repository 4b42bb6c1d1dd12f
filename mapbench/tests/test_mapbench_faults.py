"""A whole run of a cell on the CPU at a small size (the harness's look
for a card skipped), sound and with the timed path broken underneath:
the sound run is correct, each fault makes `correct` false."""
import os

import pytest

from mapbench import run

SMALL = {"length": 200_000, "pool_reads": 4096, "warmup_reads": 33_000,
         "sample_reads": 48}


def _judge(monkeypatch, fault=None, seed=977):
    if fault is not None:
        monkeypatch.setenv("MAPBENCH_TEST_FAULT", fault)
    r = run.run_cell("ecoli-ls.se36", seed, 14.0, False, device="cpu",
                     overrides=SMALL,
                     child_module=("mapbench.tests.faulty_child" if fault
                                   else "mapbench.child"))
    assert r["reads"] > 0 and r["cli_windows"] >= 2
    return run.check_output(r)


def test_sound_run_is_correct(monkeypatch):
    res = _judge(monkeypatch)
    assert res["seen"] > 0 and res["bad"] == 0


@pytest.mark.parametrize("fault", ["drop_half", "alter", "repeat"])
def test_fault_is_caught(monkeypatch, fault):
    res = _judge(monkeypatch, fault)
    assert res["seen"] > 0 and res["bad"] > 0


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell through the command, on the card."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-m", "mapbench.run", "--workload", "ecoli-ls.se36",
         "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
