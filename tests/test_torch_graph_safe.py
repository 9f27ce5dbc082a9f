"""The graphed bounce loop on the CPU (integrator/graphs.py,
integrator/path.py `_Trace`, render/renderer.py `_Frame`).

On a card each step of the loop (camera rays, the unrolled form's
segments or a block of the looped form's, the accumulation) is captured
once as a CUDA graph and replayed, so a step must not read the host: a
capture would freeze what it read. Here the steps run eagerly, each
inside `no_host_reads`, which makes every way a tensor reaches the host
(`bool`, `int`, `float`, `index`, `item`, `tolist`, `cpu`, `numpy`)
raise, and `torch.tensor` / `torch.as_tensor` of host data too (on a
card, a host-to-device copy). A device-side choice (graphs.cond /
choose, on a card an IF node of the graph) reads its predicate here and
is counted apart (`conds`). The loop's own reads between steps are
counted: none in the unrolled form, one a block of the looped form's
segments at most.

Tolerances: the sample index as a tensor or an int gives the same RNG
states bit for bit, and both the JAX package's. Against the JAX render
the image bar of tests/test_torch_render.py holds (>= 99% of pixels
within 1e-3, abs + rel; means within 1e-3 relative).
"""

import contextlib

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.accel import launch as PL
from moonshine_tpu_torch.accel import packet as PP
from moonshine_tpu_torch.accel import treelet as PT
from moonshine_tpu_torch.accel import wide as PW
from moonshine_tpu_torch.core import rng as R
from moonshine_tpu_torch.integrator import graphs
from moonshine_tpu_torch.integrator import path as P
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.parallel import mesh_from_spec, render_sharded
from moonshine_tpu_torch.render import renderer as RR
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.scene import procedural

from test_torch_render import assert_image_close

CFG = dict(max_bounces=4, env_samples_per_bounce=1,
           mesh_samples_per_bounce=1)
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
              "tolist", "cpu", "numpy", "__array__")


class HostRead(AssertionError):
    pass


_ALLOWED = []  # non-empty: host reads pass (a plain version's)


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor, and torch.tensor / torch.as_tensor of
    host data, raises HostRead inside the block (unless `allowed`)."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    tensor, as_tensor = torch.tensor, torch.as_tensor

    def refuse(name):
        def read(self, *args, **kwargs):
            if _ALLOWED:
                return saved[name](self, *args, **kwargs)
            raise HostRead(f"Tensor.{name} inside a step")
        return read

    def as_tensor_of_tensors(data, *args, **kwargs):
        if not (_ALLOWED or torch.is_tensor(data)):
            raise HostRead("torch.as_tensor of host data inside a step")
        return as_tensor(data, *args, **kwargs)

    def no_tensor(*args, **kwargs):
        if not _ALLOWED:
            raise HostRead("torch.tensor inside a step")
        return tensor(*args, **kwargs)

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    torch.as_tensor, torch.tensor = as_tensor_of_tensors, no_tensor
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        torch.as_tensor, torch.tensor = as_tensor, tensor


def allowed(fn):
    """fn with host reads allowed: a kernel's plain version, which stands
    in here for a launch (a launch reads nothing on the host)."""
    def call(*args, **kwargs):
        _ALLOWED.append(1)
        try:
            return fn(*args, **kwargs)
        finally:
            _ALLOWED.pop()
    return call


@pytest.fixture
def guarded(monkeypatch):
    """Every step runs inside no_host_reads; returns the step keys run, a
    count of the loop's host reads between steps (Tensor.__int__), the
    device-side choices' reads (`conds`, allowed inside a step: on a card
    an IF node) and the segments run, as ("body", last, roulette,
    presorted) or ("resorted", width, last, roulette, src, prefix)."""
    run, to_int = graphs.Steps.run, torch.Tensor.__int__
    body, resorted = P._Trace._body, P._Trace._resorted
    read_choice = graphs._read_choice
    seen = {"steps": [], "reads": 0, "conds": 0, "segments": []}

    def guarded_run(self, key, fn):
        seen["steps"].append(key)
        with no_host_reads():
            run(self, key, fn)

    def counted_int(self):
        seen["reads"] += 1
        return to_int(self)

    def counted_choice(index):
        seen["conds"] += 1
        return allowed(read_choice)(index)

    def seen_body(self, scene, last, roulette, presorted):
        seen["segments"].append(("body", last, roulette, presorted))
        body(self, scene, last, roulette, presorted)

    def seen_resorted(self, scene, src, prefix, width, last, roulette):
        seen["segments"].append(("resorted", width, last, roulette, src,
                                 prefix))
        resorted(self, scene, src, prefix, width, last, roulette)

    monkeypatch.setattr(graphs.Steps, "run", guarded_run)
    monkeypatch.setattr(torch.Tensor, "__int__", counted_int)
    monkeypatch.setattr(graphs, "_read_choice", counted_choice)
    monkeypatch.setattr(P._Trace, "_body", seen_body)
    monkeypatch.setattr(P._Trace, "_resorted", seen_resorted)
    graphs.clear()
    yield seen
    graphs.clear()


def _port(make):
    world, lens = make()
    return world.build("cpu"), LensArrays.from_lens(lens, "cpu")


def _room():
    return procedural.room_scene(grid=2, subdivisions=2)


def _treelet_room():
    """The small room as an 8-wide / 8-slot tree of 48-row treelets."""
    scene, lens = _port(_room)
    verts = scene.tri_shade[:, 0:9].reshape(-1, 3, 3).numpy()
    return scene._replace(wide=PW.build_wide(
        verts, leaf_cap=8, width=8, device="cpu", max_rows=48)), lens


def _two_level():
    from test_torch_tlas import LENS, instanced_world, two_level
    from moonshine_tpu_torch.scene.types import Lens

    scene = two_level(lambda: instanced_world(n=6, mirrored=True,
                                              hidden=4).build("cpu"))
    assert scene.tlas is not None
    return scene, LensArrays.from_lens(Lens(**LENS), "cpu")


SCENES = {"flagship": lambda: _port(procedural.flagship_scene),
          "room": lambda: _port(_room),
          "treelet": _treelet_room,
          "two_level": _two_level}
MODES = {"flagship": "vmem", "room": "hbm", "treelet": "treelet",
         "two_level": "tlas"}


def _dispatch(monkeypatch, name):
    """The room and treelet scenes taken as HBM-class (the treelet one
    with MSN_TREELETS=1)."""
    if name in ("room", "treelet"):
        monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 0)
    if name == "treelet":
        monkeypatch.setenv("MSN_TREELETS", "1")


CASES = [(name, resort, unroll) for name in ("flagship", "room")
         for resort in (True, False) for unroll in (True, False)] + [
    (name, True, True) for name in ("treelet", "two_level")] + [
    (name, False, False) for name in ("treelet", "two_level")]


def _looped_reads(segments: int, n_segments: int) -> tuple:
    """(blocks replayed, live-count reads) of the looped form that ran
    `segments` of at most n_segments: a read after each block whose
    successor would start below the cap."""
    k = P.LOOP_BLOCK
    blocks = -(-segments // k)
    return blocks, blocks - 1 + (blocks * k < n_segments)


@pytest.mark.parametrize("name,resort,unroll", CASES)
def test_steps_read_nothing_on_the_host(guarded, monkeypatch, name, resort,
                                        unroll):
    """1 spp (64x64 = 4096 lanes for the flagship with the resort, whose
    bounces then run on a prefix; 32x32 else): no step reads the host,
    each segment class runs (bounce 0, 1-3, >= 4, the thin last
    segment), the unrolled form's sample is one step that reads nothing
    and the looped form's segments run in blocks of LOOP_BLOCK, a read of
    the live count between blocks; past that the host reads the segment
    count once, for the stats. The choices made on the device are read
    here as conds: a width a resorted segment (where the lanes reach
    _SHRINK_MIN), a guard a looped position after the first, the looped
    resorted accumulation's buffer set. The treelet walk's plain version
    (on the card a kernel launch) may read."""
    scene, lens = SCENES[name]()
    _dispatch(monkeypatch, name)
    monkeypatch.setattr(PT, "_dispatch_plain", allowed(PT._dispatch_plain))
    assert P._run_key(scene)[1] == MODES[name]
    size = 64 if name == "flagship" and resort else 32
    cfg = PathConfig(**CFG, unroll=unroll, resort_bounces=resort)
    stats = {}
    img, rays = RR.render_spp(scene, lens, size, size, 2, 1, cfg,
                              stats=stats)
    reads = guarded["reads"]
    assert np.isfinite(img.numpy()).all() and int(rays) > 0
    segs = guarded["segments"]
    segments = stats["segments"]
    assert len(segs) == segments
    # the looped form stops when no lane is live: here after bounce 4
    assert segments == 6 or (not unroll and segments == 5)
    for bounce, key in enumerate(segs):
        last, roulette = key[1:3] if key[0] == "body" else key[2:4]
        assert key[0] == ("resorted" if stats["resort"] and bounce
                          else "body")
        assert roulette == (bounce > 3)
        assert last == (unroll and bounce == 5)
    shrink = stats["resort"] and size * size >= P._SHRINK_MIN
    conds = (segments - 1) * shrink
    if unroll:
        assert guarded["steps"] == ["group"] and reads == 1
    else:
        blocks, live_reads = _looped_reads(segments, 6)
        assert guarded["steps"] == (["raygen", ("block", 0)]
                                    + [("block", P.LOOP_BLOCK)]
                                    * (blocks - 1) + ["accumulate"])
        assert reads == live_reads + 1
        # a guard a position after the first (the first block holds none
        # past the cap), the accumulation's buffer set under the resort
        conds += (min(P.LOOP_BLOCK, 6) - 1 + (blocks - 1) * P.LOOP_BLOCK
                  + stats["resort"])
    assert guarded["conds"] == conds


@pytest.mark.parametrize("unroll", [True, False])
def test_resorted_steps_sort_into_the_other_buffers(guarded, monkeypatch,
                                                    unroll):
    """Each resorted segment (the flagship, 64x64 = 4096 lanes, so deep
    bounces run on a prefix) sorts the state once, through
    core/sortutil.py, straight into the trace's other set of buffers:
    over the last segment's width (every lane past it dead), each array's
    first `width` lanes and the tail arrays whole. Its step reads nothing
    on the host; the image is the one without the resort."""
    from moonshine_tpu_torch.core import sortutil as SU

    scene, lens = _port(procedural.flagship_scene)
    calls, added = [], []
    sort_lanes = SU.sort_lanes
    add = RR._Frame._add

    def spy(key, arrays, bits, out=None, rows=None):
        assert isinstance(key, SU.KeyIn)  # the key's inputs, not a key
        calls.append((key.o.shape[0], bits, out, rows))
        return sort_lanes(key, arrays, bits, out=out, rows=rows)

    monkeypatch.setattr(SU, "sort_lanes", spy)
    monkeypatch.setattr(RR._Frame, "_add",
                        lambda self, i: added.append(i) or add(self, i))
    imgs = []
    for resort in (True, False):
        cfg = PathConfig(**CFG, unroll=unroll, resort_bounces=resort)
        imgs.append(RR.render_spp(scene, lens, 64, 64, 2, 1, cfg)[0])
    assert torch.equal(imgs[0], imgs[1])
    resorted = [k for k in guarded["segments"] if k[0] == "resorted"]
    assert len(resorted) == len(calls) >= 4
    trace = next(iter(graphs._SHAPES.values()))[0].trace
    names = [k for k in trace.bufs[0] if k != "rays"]
    prefix, src = 4096, 0
    for (_, width, _, _, key_src, key_prefix), (n, bits, out, rows) in zip(
            resorted, calls):
        assert (key_src, key_prefix, n) == (src, prefix, prefix)
        assert bits == P.RESORT_BITS
        assert all(o is trace.bufs[1 - src][k] for k, o in zip(names, out))
        assert rows == [4096 if k in P._TAIL else width for k in names]
        prefix, src = width, 1 - src
    assert prefix < 4096  # the deep bounces ran on a prefix
    # the resorted render's accumulation reads the set its last segment
    # wrote (then the render without the resort reads its one set)
    assert added == [src, 0]


def test_staged_and_sharded_steps_read_nothing_on_the_host(guarded,
                                                            monkeypatch):
    """The staged path (two samples batched on the lane axis, the first
    segment sorted inside traversal), banded samples and render_sharded
    run the same steps, and read the host only between them."""
    scene, lens = _port(_room)
    monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 0)
    cfg = PathConfig(**CFG)
    stats = {}
    staged, _ = RR._render_spp_staged(scene, lens, 32, 32, 0, 2, cfg,
                                      batch=2, stats=stats)
    assert stats["segments"] == 6 and stats["resort"]
    band, _ = RR.render_sample(scene, lens, 32, 32, 0, cfg, y0=8, band_h=8)
    mesh = mesh_from_spec("2,2", "cpu")
    sharded, _ = render_sharded(scene, lens, 32, 32, 2, cfg, mesh)
    assert ("body", False, False, False) in guarded["segments"]
    fused, _ = RR.render_spp(scene, lens, 32, 32, 0, 2, cfg)
    assert torch.equal(staged, fused)
    assert torch.equal(band, RR.render_sample(scene, lens, 32, 32, 0,
                                              cfg)[0][8:16])
    torch.testing.assert_close(sharded, fused / 2, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("unroll", [False, True])
def test_stepped_shards_read_each_live_count_once(guarded, monkeypatch,
                                                  unroll):
    """render_sharded steps its four shards (the small room, 32x32 x 4
    spp on a 2x2 CPU mesh, resort on) together: no step reads the host,
    and the rounds read each shard's live count once a block where its
    form needs it (the looped form, here LOOP_BLOCK + 4 segments deep;
    the unrolled form reads none), exactly as often as the shards run
    alone, and the image is theirs."""
    scene, lens = _port(_room)
    monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 0)
    monkeypatch.setattr(P, "_SHRINK_MIN", 64)
    cfg = PathConfig(**dict(CFG, max_bounces=4 if unroll
                            else P.LOOP_BLOCK + 2),
                     unroll=unroll, resort_bounces=True)
    mesh = mesh_from_spec("2,2", "cpu")
    before = guarded["reads"]
    for si in range(2):
        for di in range(2):
            RR._sample_sum(scene, lens, 32, 32, si * 2, 2, cfg, True,
                           y0=di * 16, band_h=16)
    alone_reads, before = guarded["reads"] - before, guarded["reads"]
    # the unrolled form reads nothing (five reads a sample before its
    # widths were chosen on the device)
    assert alone_reads == 0 if unroll else alone_reads > 0
    img, _ = render_sharded(scene, lens, 32, 32, 4, cfg, mesh)
    assert guarded["reads"] - before == alone_reads
    fused, _ = RR.render_spp(scene, lens, 32, 32, 0, 4, cfg)
    torch.testing.assert_close(img, fused / 4, rtol=2e-6, atol=2e-6)


def test_trace_paths_steps_read_nothing_on_the_host(guarded):
    """trace_paths on the caller's rays: the rays are copied into the run
    shape's buffers outside the steps; its results equal a plain dict
    state's bounces (path._init_state, _bounce_body) run by hand."""
    scene, lens = _port(procedural.flagship_scene)
    o, d, rng, _ = RR._sample_rays(lens, 16, 16, 7, True, "cpu")
    cfg = PathConfig(**CFG, resort_bounces=False)
    radiance, _, rays, segments = P.trace_paths(scene, o, d, rng, cfg)
    assert segments == 6 and "reset" in guarded["steps"]
    st = P._init_state(o, d, rng)
    for bounce in range(6):
        st = P._bounce_body(scene, cfg, bounce, st, last=bounce == 5)
    assert torch.equal(radiance, st["radiance"])
    assert int(rays) == int(st["rays"])


@pytest.mark.parametrize("name", ["flagship", "two_level"])
def test_shading_plain_versions_read_nothing_on_the_host(guarded, name):
    """The shading kernels' plain versions (integrator/shade.py: the env
    miss and draw, the surface decode in its three forms, the full one
    with the bounce's light draw, and the scatter), which stand in for
    the launches a graph captures, read nothing on the host: each runs
    inside a guarded step on a device bounce index, on the flagship (a
    textured atlas, every material) and a two-level scene, and gives what
    it gives outside the guard."""
    from moonshine_tpu_torch.integrator import shade as S

    scene, lens = SCENES[name]()
    o, d, rng, _ = RR._sample_rays(lens, 16, 16, 3, True, "cpu")
    n = o.shape[0]
    st = P._init_state(o, d, rng)
    hit = P._closest(scene, o, d, 1e12, st["active"])
    bounce = torch.tensor(1)
    active = st["active"] & hit.is_hit
    rs = np.random.RandomState(5)
    r2 = torch.from_numpy(rs.rand(n, 2).astype(np.float32))
    thr = torch.from_numpy(rs.rand(n, 3).astype(np.float32))
    last_delta = torch.from_numpy(rs.rand(n) < 0.3)
    steps = graphs.Steps("cpu")

    def shading(out):
        rad, after_miss = S.env_miss_plain(
            scene.env, 1, bounce, d, st["active"], hit.tri, thr,
            st["radiance"], st["last_pdf"], last_delta)
        surf = {mode: S.surface_plain(
            scene, 1, bounce, hit, o, d, active, thr, rad, st["last_pdf"],
            last_delta, mode,
            S.DrawIn(scene.env, 2, 4, True, rng) if mode == S.FULL else None)
            for mode in (S.FULL, S.THIN, S.DIRECT)}
        full = surf[S.FULL]
        lights = full.lights._replace(occluded=full.lights.pdf > 1.0)
        out.update(rad=rad, after_miss=after_miss, surf=surf,
                   env_draw=S.env_draw_plain(scene.env, r2),
                   scatter=S.scatter_plain(full, o, d, full.throughput,
                                           full.radiance, full.rng,
                                           full.active, lights, {}))

    guarded_out, free_out = {}, {}
    steps.run("shade", lambda: shading(guarded_out))
    shading(free_out)
    assert ("shade" in guarded["steps"]) and guarded["reads"] == 0
    assert torch.equal(guarded_out["rad"], free_out["rad"])
    assert torch.equal(guarded_out["after_miss"], active)
    assert torch.equal(free_out["after_miss"], active)
    for got, want in zip(guarded_out["env_draw"], free_out["env_draw"]):
        assert torch.equal(got, want)
    for k in ("o", "d", "t_max", "lane"):
        assert torch.equal(getattr(guarded_out["surf"][S.FULL].shadow, k),
                           getattr(free_out["surf"][S.FULL].shadow, k))
    for k in guarded_out["scatter"]:
        assert torch.equal(guarded_out["scatter"][k], free_out["scatter"][k])
    assert int(guarded_out["scatter"]["active"].sum()) > 0


def test_a_host_read_in_a_step_raises(guarded):
    """The guard is live: a step that reads the host fails."""
    steps = graphs.Steps("cpu")
    t = torch.ones(3)
    for read in (lambda: bool(t.any()), lambda: int(t.sum()),
                 lambda: t.tolist(), lambda: float(t[0]), lambda: t.cpu(),
                 lambda: t.numpy(), lambda: t[0].item(),
                 lambda: torch.tensor([1.0]), lambda: torch.as_tensor(2.0)):
        with pytest.raises(HostRead):
            steps.run("read", read)


@pytest.mark.parametrize("sample_index", [0, 5, 2**32 + 3])
def test_seed_takes_a_device_sample_index(sample_index):
    """R.seed gives the same states for the sample index as an int and as
    an int64 tensor, and both the JAX package's seed."""
    import jax.numpy as jnp

    from moonshine_tpu.core import rng as JR

    rs = np.random.RandomState(sample_index % 97)
    x = rs.randint(0, 4096, 1000)
    y = rs.randint(0, 4096, 1000)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    as_int = R.seed(sample_index, xt, yt)
    as_tensor = R.seed(torch.tensor(sample_index, dtype=torch.int64), xt, yt)
    assert torch.equal(as_int, as_tensor)
    want = JR.seed(jnp.uint32(sample_index & 0xFFFFFFFF),
                   jnp.asarray(x, jnp.uint32), jnp.asarray(y, jnp.uint32))
    np.testing.assert_array_equal(as_int.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_graphed_loop_matches_reference(guarded):
    """The flagship, 32x32 x 1 spp, in the looped form with the resort on,
    every step guarded, against the JAX render of the same config."""
    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator.path import PathConfig as JaxPathConfig
    from moonshine_tpu.render.camera import LensArrays as JaxLens
    from moonshine_tpu.render.renderer import render_spp as jax_render_spp

    cfg = dict(CFG, unroll=False, resort_bounces=True)
    js, jlens = _flagship_scene()
    want, _ = jax_render_spp(js, JaxLens.from_lens(jlens), 32, 32, 0, 1,
                             JaxPathConfig(**cfg))
    scene, lens = _port(procedural.flagship_scene)
    got, _ = RR.render_spp(scene, lens, 32, 32, 0, 1, PathConfig(**cfg))
    assert guarded["steps"].count("raygen") == 1
    assert np.isfinite(got.numpy()).all()
    assert_image_close(got.numpy(), np.asarray(want))


def test_steps_replay_by_key_and_count_launches():
    """Steps keys its graphs by what a step does; on the CPU it runs every
    step eagerly and captures nothing. A graph's launch tally adds its
    wrappers' counts at each replay."""
    steps = graphs.Steps("cpu")
    calls = []
    steps.run("a", lambda: calls.append(1))
    steps.run("a", lambda: calls.append(2))
    assert calls == [1, 2] and not steps.capture
    counts = {"k": 0}
    with PL.launch_tally() as tally:
        PL.count_launch(counts, "k")
        PL.count_launch(counts, "k")
    assert counts["k"] == 0 and len(tally) == 2
    PL.count_replay(tally)
    PL.count_replay(tally)
    assert counts["k"] == 4
    PL.count_launch(counts, "k")
    assert counts["k"] == 5


def test_fingerprint_follows_scene_edits():
    """A scene's fingerprint changes when a tensor is replaced (World
    edits do that) or a value changes, and not otherwise; it holds no
    reference to the scene."""
    scene, _ = _port(procedural.flagship_scene)
    fp = graphs.fingerprint(scene)
    assert graphs.fingerprint(scene._replace()) == fp
    moved = scene._replace(tri_shade=scene.tri_shade.clone())
    assert graphs.fingerprint(moved) != fp
    assert graphs.fingerprint(scene._replace(has_delta=not scene.has_delta)
                              ) != fp
    env = scene.env._replace(integral=scene.env.integral + 1.0)
    assert graphs.fingerprint(scene._replace(env=env)) != fp
    with pytest.raises(TypeError):
        graphs.fingerprint(object())


def test_run_shapes_are_cached_and_bounded(monkeypatch):
    """A frame shape is made once per key, and the least recently used
    goes past MAX_RUN_SHAPES."""
    graphs.clear()
    monkeypatch.setattr(graphs, "MAX_RUN_SHAPES", 2)
    made = []
    get = lambda k: graphs.run_shape(k, lambda: made.append(k) or object())
    a = get("a")
    assert get("a") is a and made == ["a"]
    get("b")
    get("a")
    get("c")  # evicts b
    get("a")
    get("b")
    assert made == ["a", "b", "c", "b"]
    graphs.clear()


def test_run_shape_goes_with_its_scene():
    """A run shape made for a scene is dropped once one of the scene's
    tensors is freed (a World edit replaces them); one made for a scene
    whose tensors all live stays."""
    graphs.clear()
    made = []
    kept = (torch.zeros(3), (torch.ones(2), 1.0))
    edited = (torch.zeros(4), kept[1])
    get = lambda k, sc: graphs.run_shape(
        k, lambda: made.append(k) or object(), sc)
    a = get("kept", kept)
    get("edited", edited)
    edited = (torch.zeros(4), kept[1])  # the old tensor is freed
    assert get("kept", kept) is a
    get("edited", edited)
    assert made == ["kept", "edited", "edited"]
    graphs.clear()
