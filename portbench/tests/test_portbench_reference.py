"""The check that decides `correct`, on the CPU at the size of
portbench/tests/tiny.py: the plain reference agrees with the program's
CPU path in both cells; the control (the reference in bfloat16 in the
program's place) and the timed path broken underneath in each way a
cell can break come out not correct; and the card's run of a cut cell
(skipped without a card)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control
from portbench.reference import check as C
from portbench.tests.tiny import CELLS, ROOT, run_tiny, tiny


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_program(monkeypatch, workload):
    bench = tiny(monkeypatch)
    result, lines = run_tiny(bench, workload)
    assert result["correct"], lines
    assert result["check"]["off_share"]["value"] == 0.0
    assert result["check"]["mean_gap"]["value"] < 1e-6
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "check"}
    assert list(result)[-1] == "check"
    assert all(line.startswith("check ") for line in lines)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(monkeypatch, workload):
    bench = tiny(monkeypatch)
    for seed in (3, 2**31 + 5):
        numbers = control.control(ROOT, bench, workload, seed, 3, "cpu")
        assert not C.correct(numbers), numbers


def _patch_both(monkeypatch, name, make):
    """Replace the program's `name` (render_sample or accumulate) where
    the offline renderer and the Engine call it."""
    from moonshine_tpu_torch.engine import engine
    from moonshine_tpu_torch.render import renderer

    for mod in (renderer, engine):
        monkeypatch.setattr(mod, name, make(getattr(mod, name)))


def _unchanged(orig):
    """A step that returns its state unchanged: the sensor as it was."""
    return lambda sensor, img, n: sensor


def _half(orig):
    """Half of the samples left out, the mean taken over the rest: an
    odd sample repeats the even one before it."""
    last = {}

    def render_sample(scene, lens, h, w, index, *args, **kw):
        if index % 2 and (h, w) in last:
            return last[(h, w)]
        last[(h, w)] = orig(scene, lens, h, w, index, *args, **kw)
        return last[(h, w)]
    return render_sample


def _altered(orig):
    """An answer altered where it is produced: a quarter of the rows'
    radiance 2% high in one channel."""
    def render_sample(*args, **kw):
        img, rays = orig(*args, **kw)
        img = img.clone()
        img[::4, :, 1] *= 1.02
        return img, rays
    return render_sample


FAULTS = [("accumulate", _unchanged), ("render_sample", _half),
          ("render_sample", _altered)]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", range(len(FAULTS)),
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    bench = tiny(monkeypatch)
    name, make = FAULTS[fault]
    _patch_both(monkeypatch, name, make)
    # the Engine's frames fold into one sensor: a window of several, so
    # that half of them can be left out (an image holds several samples)
    online = workload == "online_room_1080p"
    result, lines = run_tiny(bench, workload, seconds=5.0 if online else 0.2)
    assert result["attempted"] >= (2 if online else 1)
    assert not result["correct"], lines
    assert result["failed"] >= 1


def test_pixels_are_drawn_from_the_seed():
    a = C.sample_pixels(2**31 + 9, 720, 1280, 1024)
    assert np.array_equal(a, C.sample_pixels(2**31 + 9, 720, 1280, 1024))
    assert len(np.unique(a)) == 1024 and a.max() < 720 * 1280
    assert not np.array_equal(a, C.sample_pixels(2**31 + 10, 720, 1280,
                                                 1024))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cut_cell_on_the_card(cuda, monkeypatch, workload):
    from portbench import run as R

    bench = tiny(monkeypatch)
    result, lines = R.run_cell(ROOT, bench, workload, 11, 0.2, True, "cuda",
                               log=lambda line: None)
    assert result["correct"], lines
    assert result["device"]["busy_s"] > 0.0
