"""Each cell run on the card for a short window, as the benchmark runs it."""
import json
import subprocess
import sys

import pytest

from portbench.harness import cell
from portbench.tests.helpers import cells


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("name", cells())
def test_cell_runs_correct_on_the_card(card, name, traced):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed", str(2**31 + 99),
                           "--seconds", "2", "--trace", str(traced)], capture_output=True, text=True,
                          cwd=cell.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
