"""What the harness loads: no module whose top-level name is jax, jaxlib,
flax or the JAX package (compared whole: the port's name begins with the
JAX package's), and a reference that loads nothing of the program; and
the command's exit without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.tiny import CELLS, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "moonshine_tpu")

# runs both cut cells through the harness on the CPU in a fresh process,
# then lists every loaded module's top-level name
RUN_BOTH = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import pytest
from portbench import run as R
from portbench.tests.tiny import run_tiny, tiny
mp = pytest.MonkeyPatch()
bench = tiny(mp)
for workload in {CELLS!r}:
    result, _ = run_tiny(bench, workload, trace=True)
    assert result["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import portbench.control, portbench.reference.check, portbench.scenes.room
from portbench.reference import scene, tracer
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    names = _top_names(RUN_BOTH)
    assert "moonshine_tpu_torch" in names and "portbench" in names
    assert not set(names) & set(FORBIDDEN), set(names) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_names(REFERENCE_ONLY)
    assert "moonshine_tpu_torch" not in names
    assert not set(names) & set(FORBIDDEN)


def test_command_without_a_card_exits_without_a_result():
    if _has_card():
        pytest.skip("a card is present: this holds the exit without one")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()
