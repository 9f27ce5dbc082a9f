"""The bounce loop's device-side control on the CPU (integrator/graphs.py
`cond` / `choose`, integrator/path.py `_Trace`): the reference's
lax.cond of the live prefix's width and the while_loop's cond of its
looped form, which on a card are IF nodes of the captured graphs and
here read their predicates eagerly.

The width chosen from the live count on the device is `_prefix_width`'s
at every boundary; the unrolled resorted form reads nothing on the host;
the looped form reads the live count at most once a block of LOOP_BLOCK
segments (+1). The looped form in blocks against the JAX package's
looped trace_paths on the same rays (made by the port's camera from a
seed, passed to both as numpy arrays): the image at
tests/test_torch_render.py's bar, the RNG states and the ray count
exactly, and the segments equal the reference's while_loop trip count;
a scene where every lane dies before the cap (with the resort on: the
state's buffer set is the parity of the segment count), and one where
the cap stops the loop.
"""

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.integrator import graphs
from moonshine_tpu_torch.integrator import path as P
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.render import renderer as RR
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.scene import procedural

from test_torch_graph_safe import guarded  # noqa: F401  (a fixture)
from test_torch_render import assert_image_close

CFG = dict(max_bounces=4, env_samples_per_bounce=1,
           mesh_samples_per_bounce=1)


def _flagship():
    world, lens = procedural.flagship_scene()
    return world.build("cpu"), LensArrays.from_lens(lens, "cpu")


@pytest.mark.parametrize("n", [P._SHRINK_MIN, 4099, 65536, 65539, 921_600,
                               2_073_600])
def test_width_index_gives_prefix_width(n):
    """The width chosen on the device from the live count, a bucketize
    over the trace's bounds (`_widths(n)` but the last), is
    `_prefix_width`'s at 0, 1, n - 1, n and at every width and one either
    side of it (n not a multiple of 4 too), at the offline CLI's and a
    1080p frame's lane counts too."""
    widths = P._widths(n)
    bounds = torch.tensor(widths[:-1], dtype=torch.int64)
    lives = {0, 1, n - 1, n}
    lives |= {w + e for w in widths for e in (-1, 0, 1) if 0 <= w + e <= n}
    for live in sorted(lives):
        index = P._width_index(torch.tensor(live, dtype=torch.int64),
                               bounds)
        assert index.dtype == torch.int64 and index.dim() == 0
        assert P._widths(n)[int(index)] == P._prefix_width(n, live)
        assert P._prefix_width(n, live) >= live
        assert int(index) == 0 or widths[int(index) - 1] < live


def test_below_shrink_min_every_segment_runs_every_lane(guarded):
    """Below _SHRINK_MIN lanes (32x32) a resorted segment runs over every
    lane and sorts every lane, and no width is chosen on the device."""
    scene, lens = _flagship()
    assert 32 * 32 < P._SHRINK_MIN
    cfg = PathConfig(**CFG, resort_bounces=True)
    RR._sample_sum(scene, lens, 32, 32, 0, 1, cfg, True)
    resorted = [k for k in guarded["segments"] if k[0] == "resorted"]
    assert len(resorted) == 5
    assert all(k[1] == 1024 and k[5] == 1024 for k in resorted)
    assert guarded["conds"] == 0 and guarded["reads"] == 0


def test_unrolled_resorted_sample_reads_nothing(guarded):
    """A sample of the unrolled resorted form (the flagship, 64x64 = 4096
    lanes, whose segments take live prefixes) is one step and reads the
    host 0 times (5 before its widths were chosen on the device): its
    five width choices are device-side (conds)."""
    scene, lens = _flagship()
    cfg = PathConfig(**CFG, resort_bounces=True)
    RR._sample_sum(scene, lens, 64, 64, 0, 1, cfg, True)
    widths = [k[1] for k in guarded["segments"] if k[0] == "resorted"]
    assert len(widths) == 5 and min(widths) < 4096
    assert guarded["steps"] == ["group"]
    assert guarded["reads"] == 0 and guarded["conds"] == 5


@pytest.mark.parametrize("resort", [False, True])
def test_looped_form_reads_once_a_block(guarded, resort):
    """The looped form LOOP_BLOCK + 4 segments deep (the small room,
    32x32 x 1 spp, whose lanes reach the cap): a sample's blocks replay
    the first block's step and then one shared step, and the live count
    is read at most ceil(segments / LOOP_BLOCK) + 1 times, besides the
    stats' read of the segment count."""
    world, lens = procedural.room_scene(grid=2, subdivisions=2)
    scene = world.build("cpu")
    cfg = PathConfig(**dict(CFG, max_bounces=P.LOOP_BLOCK + 2),
                     unroll=False, resort_bounces=resort)
    stats = {}
    RR.render_spp(scene, LensArrays.from_lens(lens, "cpu"), 32, 32, 0, 1,
                  cfg, stats=stats)
    segments = stats["segments"]
    blocks = [k for k in guarded["steps"] if k[0] == "block"]
    assert blocks[0] == ("block", 0) and len(blocks) > 1
    assert set(blocks[1:]) == {("block", P.LOOP_BLOCK)}
    assert len(guarded["segments"]) == segments > P.LOOP_BLOCK
    assert guarded["reads"] - 1 <= -(-segments // P.LOOP_BLOCK) + 1


def _jax_traces(rays, max_bounces, monkeypatch):
    """The JAX package's looped trace_paths with the resort on, on the
    flagship and each of `rays` (o, d, rng as numpy): [(radiance, rng,
    rays, its while_loop's trip count, read from the loop's final
    carry)]."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator import path as JP

    trips = []
    while_loop = jax.lax.while_loop

    def counted(cond, body, init):
        out = while_loop(cond, body, init)
        if cond.__qualname__ == "trace_paths.<locals>.cond":
            trips.append(int(out[0]))  # not the kernels' own loops
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counted)
    js, _ = _flagship_scene()
    cfg = JP.PathConfig(**dict(CFG, max_bounces=max_bounces), unroll=False,
                        resort_bounces=True)
    out = []
    for o, d, rng in rays:
        radiance, rng_out, n_rays = JP.trace_paths(
            js, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(rng.astype(np.uint32)), cfg)
        out.append((np.asarray(radiance),
                    np.asarray(rng_out).astype(np.int64), float(n_rays),
                    trips[-1]))
    assert len(trips) == len(rays)
    return out


def test_looped_blocks_match_reference(guarded, monkeypatch):
    """trace_paths' looped form in blocks of LOOP_BLOCK segments, resort
    on, 18 segments at most, against the JAX package's looped
    trace_paths on the flagship's 16x16 camera rays: of sample 4, whose
    every lane dies in the second block (the state's buffer set then the
    parity of an odd segment count), and of sample 3, whose loop the cap
    stops (an even count). Segments equal the reference's trip count;
    the RNG states are the reference's exactly, compared as sets (both
    come back in lane order, and the reference's looped form also
    resorts before its first segment); image and rays at
    tests/test_torch_render.py's bars (one ray of 645 differs on
    sample 4 without the resort too: the two frameworks' rounding). The
    blocks here are 8 segments (LOOP_BLOCK is a tuning constant; any
    even size from 4 gives the same results), and in blocks of 4 the port
    gives the same results bit for bit."""
    monkeypatch.setattr(P, "LOOP_BLOCK", 8)
    scene, lens = _flagship()
    max_bounces = 16
    cfg = PathConfig(**dict(CFG, max_bounces=max_bounces), unroll=False,
                     resort_bounces=True)
    rays = [RR._sample_rays(lens, 16, 16, i, True, "cpu")[:3]
            for i in (4, 3)]
    wants = _jax_traces([[x.numpy() for x in r] for r in rays],
                        max_bounces, monkeypatch)
    runs = []
    for (o, d, rng), want in zip(rays, wants):
        got = P.trace_paths(scene, o, d, rng, cfg)
        radiance, rng_out, n_rays, segments = got
        runs.append(segments)
        assert segments == want[3]
        assert np.isfinite(radiance.numpy()).all()
        assert_image_close(radiance.numpy().reshape(16, 16, 3),
                           want[0].reshape(16, 16, 3))
        np.testing.assert_array_equal(np.sort(rng_out.numpy()),
                                      np.sort(want[1]))
        assert abs(int(n_rays) / want[2] - 1.0) <= 1e-2
        with monkeypatch.context() as m:
            m.setattr(P, "LOOP_BLOCK", 4)
            graphs.clear()
            again = P.trace_paths(scene, o, d, rng, cfg)
        for a, b in zip(got[:3], again[:3]):
            assert torch.equal(a, b)
        assert again[3] == segments
    # the first dies past the first block, the second reaches the cap
    assert P.LOOP_BLOCK < runs[0] < max_bounces + 2 == runs[1]
    assert runs[0] % 2 != runs[1] % 2
    steps = guarded["steps"]
    assert steps.count("reset") == steps.count("finish") == 4


def test_choose_without_a_matching_key_runs_nothing():
    """graphs.choose eagerly: the branch of the index's value, for every
    (prev, w) pair of a resorted segment's width choice and an int64 and
    a bool index; nothing where no key matches (a SWITCH node's index
    past its bodies); one read of the index each."""
    ran = []
    branches = {(p, k): (lambda p=p, k=k: ran.append((p, k)))
                for p in range(3) for k in range(p + 1)}
    graphs.reset_counts()
    calls = 0
    for p in range(-1, 4):
        for k in range(-1, 4):
            ran.clear()
            graphs.choose((torch.tensor(p), torch.tensor(k)), branches)
            calls += 1
            assert ran == ([(p, k)] if (p, k) in branches else [])
    for value, keys in ((True, {False: 0}), (False, {True: 1}),
                        (True, {True: 1, False: 0})):
        ran.clear()
        graphs.choose(torch.tensor(value),
                      {key: (lambda v=v: ran.append(v))
                       for key, v in keys.items()})
        calls += 1
        assert ran == ([int(value)] if value in keys else [])
    ran.clear()
    graphs.choose(torch.tensor(9, dtype=torch.int64),
                  {0: lambda: ran.append(0), 1: lambda: ran.append(1)})
    assert ran == [] and graphs.COUNTS["conds"] == calls + 1


@pytest.mark.parametrize("guard_first", [False, True])
def test_loop_stops_at_no_live_lane_and_stays_stopped(guard_first):
    """graphs.loop eagerly, as the looped form's block runs it: each step
    sets the live count from a schedule and then the counter advances;
    once the live count reaches 0 (after the third step) no later step
    runs, though a later one would make lanes live again, and the
    counter stays at 3; a cap on the counter stops the loop as well.
    Each guard is read once (the unguarded first step reads none)."""
    for schedule, cap, runs in (([3, 2, 0, 5, 5, 5, 5, 5], 99, 3),
                                ([4, 4, 4, 4, 4, 4, 4, 4], 5, 5)):
        live = torch.tensor(7, dtype=torch.int64)
        bounce = torch.zeros((), dtype=torch.int64)
        ran = []

        def step(i):
            ran.append(i)
            live.fill_(schedule[i])

        graphs.reset_counts()
        graphs.loop(((live, ">", 0), (bounce, "<", cap)),
                    [lambda i=i: step(i) for i in range(len(schedule))],
                    bounce, lambda: bounce.add_(1), guard_first=guard_first)
        assert ran == list(range(runs)) and int(bounce) == runs
        assert int(live) == schedule[runs - 1]
        assert graphs.COUNTS["conds"] == len(schedule) - (not guard_first)
