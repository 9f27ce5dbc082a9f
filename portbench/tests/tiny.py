"""Both cells cut to a size a CPU test run holds: the same files, the
frame, samples and room made small, for the CPU tests of portbench/tests
(run with `python -m pytest portbench/tests`)."""

from __future__ import annotations

import pathlib

from portbench import run as R

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("offline_room_720p", "online_room_1080p")


def tiny(monkeypatch) -> dict:
    """Patch portbench.run.cell_files to cut each cell to 16x12 pixels,
    2 samples an image, a 2x2 room of icospheres of one subdivision and a
    32x16 sky; return BENCHMARK.json."""
    orig = R.cell_files

    def cut(root, bench, workload):
        cell, config, traffic = orig(root, bench, workload)
        config = dict(config, width=16, height=12, spp=min(config["spp"], 2),
                      trace_units=1,
                      check=dict(config["check"], pixels=48))
        traffic = dict(traffic, scene_args=dict(
            traffic["scene_args"], grid=2, subdivisions=1, sky_height=16,
            sky_width=32))
        return cell, config, traffic

    monkeypatch.setattr(R, "cell_files", cut)
    return R.load_json(ROOT / "BENCHMARK.json")


def run_tiny(bench, workload: str, seed: int = 2**31 + 17,
             trace: bool = False, seconds: float = 0.2):
    """run_cell of the cut cell on the CPU: (result, check lines)."""
    return R.run_cell(ROOT, bench, workload, seed, seconds, trace, "cpu",
                      log=lambda line: None)
