"""The port's sharded render (parallel/sharding.py), mirroring
tests/test_parallel.py on a mesh of ["cpu"] * 8 (the executable-cache
case has no torch meaning and is left out): the sharded image equals the
port's single-device render within 2e-6 absolute (the reference test's
bar) on 2x4 and 8x1 meshes, staged or not, and the JAX package's
render_sharded on the conftest's 8-device CPU mesh within the image gate
of PERF.md §2; the Engine, the viewer and the CLI's --mesh reach it."""

import warnings
from dataclasses import replace

import numpy as np
import pytest
import torch

from moonshine_tpu_torch import parallel as par
from moonshine_tpu_torch.engine import Engine
from moonshine_tpu_torch.integrator import graphs
from moonshine_tpu_torch.integrator import path as P
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.parallel import (
    make_mesh, mesh_from_spec, render_sharded, visible_devices,
)
from moonshine_tpu_torch.render import renderer as RR
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.render.renderer import render
from moonshine_tpu_torch.render.viewer import Viewer
from moonshine_tpu_torch.scene import types as PT
from moonshine_tpu_torch.scene.types import Lens, translate
from moonshine_tpu_torch.scene.world import World

from fixtures import icosphere
from test_torch_incremental import port_mesh
from test_torch_render import assert_image_close

CPU8 = ["cpu"] * 8


def furnace_world(albedo=0.6):
    """tests/test_furnace.py's furnace_world on the port's types."""
    w = World()
    mesh = w.add_mesh(port_mesh(icosphere(3, with_normals=False)))
    mat = w.add_material(PT.MaterialInfo(
        variant=PT.Lambert(color=(albedo, albedo, albedo))))
    w.add_instance(PT.Instance(transform=PT.identity_transform(),
                               geometries=[PT.Geometry(mesh, mat)]))
    w.set_background(None)
    return w


def outside_lens():
    return Lens(origin=np.float32([0.0, -3.0, 0.0]),
                forward=np.float32([0.0, 1.0, 0.0]),
                up=np.float32([0.0, 0.0, 1.0]), vfov=np.pi / 4)


@pytest.fixture(scope="module")
def setup():
    scene = furnace_world().build("cpu")
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=0, unroll=False)
    return scene, outside_lens(), cfg


def lens_arrays(lens):
    return LensArrays.from_lens(lens, "cpu")


class TestMesh:
    def test_eight_cpu_devices(self):
        assert visible_devices("cpu") == [torch.device("cpu")] * 8
        m = make_mesh(CPU8)
        assert m.shape == {"sp": 2, "dp": 4}
        assert mesh_from_spec("auto", "cpu").shape == {"sp": 2, "dp": 4}
        assert mesh_from_spec("1,8", "cpu").shape == {"sp": 1, "dp": 8}
        assert make_mesh(CPU8[:3]).shape == {"sp": 1, "dp": 3}

    def test_spec_errors(self):
        with pytest.raises(ValueError, match="needs 9"):
            mesh_from_spec("3,3", "cpu")
        with pytest.raises(ValueError, match="SP,DP"):
            mesh_from_spec("2x4", "cpu")
        if torch.cuda.device_count() == 0:  # the spec counts CUDA devices
            with pytest.raises(ValueError, match="have 0"):
                mesh_from_spec("1,1")


class TestSharded:
    def test_matches_single_device(self, setup):
        scene, lens, cfg = setup
        H, W, spp = 16, 16, 4
        sensor, rays_single = render(scene, lens, H, W, spp, cfg)
        img, rays = render_sharded(scene, lens_arrays(lens), H, W, spp, cfg,
                                   make_mesh(CPU8, sp=2))
        assert int(rays) == rays_single > 0
        np.testing.assert_allclose(img.numpy(), sensor.image.numpy(),
                                   atol=2e-6)

    def test_pure_dp_mesh(self, setup):
        scene, lens, cfg = setup
        H, W, spp = 16, 16, 2
        img, _ = render_sharded(scene, lens_arrays(lens), H, W, spp, cfg,
                                make_mesh(CPU8, sp=1))
        sensor, _ = render(scene, lens, H, W, spp, cfg)
        np.testing.assert_allclose(img.numpy(), sensor.image.numpy(),
                                   atol=2e-6)

    def test_each_shard_runs_under_its_device(self, setup, monkeypatch):
        """Every shard is set up and stepped with its own device made
        current (`_current`, with the shard's stream for its steps), and
        the shards step in rounds: each live shard's step, then each
        one's read of its live count, the next round's steps as many as
        the reads. The image is the same bit for bit as without the
        hooks."""
        scene, lens, cfg = setup
        mesh = make_mesh(CPU8, sp=2)
        want, rays_want = render_sharded(scene, lens_arrays(lens), 16, 16, 4,
                                         cfg, mesh)
        log = []
        real_current = par.sharding._current
        real_count = P._Trace.live_count

        def current(device, *stream):
            log.append(("step" if stream else "setup", device))
            return real_current(device, *stream)

        def live_count(trace):
            log.append(("read", None))
            return real_count(trace)

        monkeypatch.setattr(par.sharding, "_current", current)
        monkeypatch.setattr(P._Trace, "live_count", live_count)
        got, rays = render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg,
                                   mesh)
        assert torch.equal(got, want) and int(rays) == int(rays_want)
        devices = list(mesh.devices.flat)
        assert [d for k, d in log if k == "setup"] == devices
        kinds = "".join(k[0] for k, _ in log if k != "setup")
        rounds = kinds.replace("rs", "r s").split()
        assert rounds[0].startswith("s" * len(devices))
        assert len(rounds) > 2  # the looped form reads every segment
        for now, nxt in zip(rounds, rounds[1:] + [""]):
            steps, reads = now.count("s"), now.count("r")
            assert now == "s" * steps + "r" * reads and reads <= steps
            assert nxt.count("s") == reads

    def test_rejects_bad_shapes(self, setup):
        scene, lens, cfg = setup
        with pytest.raises(ValueError):
            render_sharded(scene, lens_arrays(lens), 15, 16, 4, cfg,
                           make_mesh(CPU8, sp=2))

    def test_staged_path_matches(self, setup):
        scene, lens, cfg = setup
        mesh = make_mesh(CPU8, sp=2)
        fused, _ = render_sharded(scene, lens_arrays(lens), 16, 16, 2, cfg,
                                  mesh, staged=False)
        staged, _ = render_sharded(scene, lens_arrays(lens), 16, 16, 2, cfg,
                                   mesh, staged=True)
        np.testing.assert_allclose(staged.numpy(), fused.numpy(), atol=2e-6)

    def test_deep_bounce_staged_falls_back(self, setup):
        scene, lens, _ = setup
        deep = PathConfig(max_bounces=16, env_samples_per_bounce=1,
                          mesh_samples_per_bounce=0, unroll=False)
        mesh = make_mesh(CPU8, sp=2)
        want, _ = render_sharded(scene, lens_arrays(lens), 16, 16, 2, deep,
                                 mesh, staged=False)
        got, _ = render_sharded(scene, lens_arrays(lens), 16, 16, 2, deep,
                                mesh, staged=True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)

    def test_matches_jax_render_sharded(self, setup):
        """The JAX package's render_sharded on its 8-device CPU mesh
        (sp=2), Pallas kernels in interpret mode, against the port's."""
        import jax

        from moonshine_tpu.integrator import PathConfig as JaxPathConfig
        from moonshine_tpu.parallel import make_mesh as jax_make_mesh
        from moonshine_tpu.parallel import render_sharded as jax_sharded
        from moonshine_tpu.render.camera import LensArrays as JaxLens
        from test_furnace import furnace_world as jax_furnace_world

        scene, lens, cfg = setup
        assert len(jax.devices()) == 8
        jcfg = JaxPathConfig(max_bounces=4, env_samples_per_bounce=1,
                             mesh_samples_per_bounce=0, unroll=False)
        want, want_rays = jax_sharded(
            jax_furnace_world(albedo=0.6).build(),
            JaxLens.from_lens(outside_lens()), 16, 16, 4, jcfg,
            jax_make_mesh(sp=2))
        got, rays = render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg,
                                   make_mesh(CPU8, sp=2))
        assert_image_close(got.numpy(), np.asarray(want))
        assert int(rays) == int(float(want_rays))


# --- the stepped render against its shards run alone ---

def far_lens():
    """The furnace sphere from twice as far: the top and bottom quarters
    of the frame miss it, so their shards' looped forms end a segment
    before the middle's."""
    return Lens(origin=np.float32([0.0, -6.0, 0.0]),
                forward=np.float32([0.0, 1.0, 0.0]),
                up=np.float32([0.0, 0.0, 1.0]), vfov=np.pi / 4)


def _room_scene():
    from moonshine_tpu_torch.scene import procedural

    world, lens = procedural.room_scene(grid=2, subdivisions=2)
    return world.build("cpu"), lens


def _two_level_scene():
    from test_torch_tlas import LENS, instanced_world, two_level

    scene = two_level(lambda: instanced_world(n=6, mirrored=True,
                                              hidden=4).build("cpu"))
    assert scene.tlas is not None
    return scene, Lens(**LENS)


DEEP = dict(max_bounces=16, env_samples_per_bounce=1,
            mesh_samples_per_bounce=0)
FORMS = {  # name: (make scene and lens, H, W, spp, cfg, staged, sp)
    "fused": (_room_scene, 32, 32, 2, dict(max_bounces=4), False, 2),
    "staged": (_room_scene, 32, 32, 2, dict(max_bounces=4), True, 2),
    "looped_deep": (lambda: (furnace_world().build("cpu"), outside_lens()),
                    16, 16, 4, DEEP, None, 2),
    "uneven_ends": (lambda: (furnace_world().build("cpu"), far_lens()),
                    16, 16, 2, DEEP, None, 1),
    "two_level": (_two_level_scene, 32, 32, 2, dict(max_bounces=4), None,
                  2),
}


def shards_alone(scene, la, H, W, spp, cfg, mesh, staged, base=0):
    """Each shard through renderer._sample_sum on its own, composed as
    render_sharded composes: the sp partials of each band added in sp
    order, divided by spp, the bands stacked. Returns (image, rays,
    {(si, di): segments})."""
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    rows, local = H // dp, spp // sp
    parts = {(si, di): RR._sample_sum(scene, la, H, W, base + si * local,
                                      local, cfg, True, y0=di * rows,
                                      band_h=rows, staged=staged)
             for si in range(sp) for di in range(dp)}
    bands = []
    for di in range(dp):
        acc = parts[(0, di)][0]
        for si in range(1, sp):
            acc = acc + parts[(si, di)][0]
        bands.append(acc / spp)
    rays = sum(int(p[1]) for p in parts.values())
    return (torch.cat(bands), rays,
            {j: p[2] for j, p in parts.items()})


@pytest.mark.parametrize("form", sorted(FORMS))
def test_stepped_equals_its_shards_alone(form):
    """render_sharded, every shard stepped together, equals bit for bit
    (image and rays) its shards run alone and composed: the fused and
    staged forms on the small room (resort on), the looped deep-bounce
    form, a mesh whose shards end their looped forms at different
    segments, and a two-level scene."""
    make, H, W, spp, cfg, staged, sp = FORMS[form]
    scene, lens = make()
    la = lens_arrays(lens)
    cfg = PathConfig(**{"env_samples_per_bounce": 1,
                        "mesh_samples_per_bounce": 1, **cfg})
    mesh = make_mesh(CPU8 if sp == 2 else CPU8[:4], sp=sp)
    img, rays = render_sharded(scene, la, H, W, spp, cfg, mesh, base_sample=3,
                               staged=staged)
    if staged is None and cfg.max_bounces + 2 > 10:
        cfg = replace(cfg, unroll=False)
    want, want_rays, segments = shards_alone(
        scene, la, H, W, spp, cfg, mesh, bool(staged), base=3)
    assert torch.equal(img, want) and int(rays) == want_rays > 0
    if form == "uneven_ends":
        assert len(set(segments.values())) > 1, segments


def _clone_all(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone_all(v) for v in x))
    return x


def _slotted():
    """The cached frame shapes of sharded renders (keyed by a slot)."""
    return [k for k in graphs._SHAPES if k[0] == "frame" and k[-1]]


def test_sample_shards_on_one_device_get_their_own_run_shapes(setup):
    """On a mesh that repeats a device, the two sample shards of a band
    share the scene and the rows; each still gets its own run shape (its
    buffers, graphs and lock)."""
    scene, lens, cfg = setup
    graphs.clear()
    render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg,
                   make_mesh(CPU8[:4], sp=2))
    slots = [k[-1] for k in _slotted()]
    assert sorted(slots) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    graphs.clear()


def test_second_call_copies_nothing_and_replays(monkeypatch):
    """Another device's scene copy is made once and kept: a second call
    on the same scene and mesh makes no copy and no run shape. An edit
    that replaces a scene tensor gives a new copy at the next call, and
    the old copy and its run shapes go once the old tensor is freed. A
    device entry of "cpu:0" differs from the scene's "cpu", so each
    shard takes the copy path; `_moved` clones, as a move to a card
    would copy."""
    import weakref

    copies = []
    monkeypatch.setattr(par.sharding, "_moved", lambda x, device: (
        copies.append(device) or _clone_all(x)))
    graphs.clear()
    graphs.reset_counts()
    scene = furnace_world().build("cpu")
    la = lens_arrays(outside_lens())
    cfg = PathConfig(max_bounces=2, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=0)
    mesh = make_mesh([torch.device("cpu", 0)] * 4, sp=2)
    first, _ = render_sharded(scene, la, 16, 16, 2, cfg, mesh)
    assert len(copies) == 1
    shapes = set(graphs._SHAPES)
    again, _ = render_sharded(scene, la, 16, 16, 2, cfg, mesh)
    assert len(copies) == 1 and set(graphs._SHAPES) == shapes
    assert torch.equal(first, again)
    copy = par.sharding.scene_on(scene, mesh.devices[0, 0])
    assert len(copies) == 1 and copy.tri_shade is not scene.tri_shade
    old_copy = weakref.ref(copy.tri_shade)
    del copy
    edited = scene._replace(tri_shade=scene.tri_shade.clone())
    del scene  # the old tri_shade goes: its copy and that copy's shapes
    assert old_copy() is None
    assert not _slotted()
    img, _ = render_sharded(edited, la, 16, 16, 2, cfg, mesh)
    assert len(copies) == 2 and len(_slotted()) == 4
    assert graphs.COUNTS["copies"] == 2
    assert torch.equal(img, first)
    graphs.clear()


def test_a_mesh_keeps_its_shapes_beside_single_device_ones(setup):
    """The run-shape cache keeps MAX_RUN_SHAPES (8) shapes, and beside
    them as many as the last sharded render's mesh has shards and scene
    copies: a 2x2 mesh's four frames outlast eight single-device shapes
    made between two calls, so the second call makes no shape; without
    a mesh the bound stays 8."""
    scene, lens, cfg = setup
    graphs.clear()  # and the room kept for a mesh
    for i in range(10):
        graphs.run_shape(("single", i), object)
    assert len(graphs._SHAPES) == graphs.MAX_RUN_SHAPES == 8
    mesh = make_mesh(CPU8[:4], sp=2)
    render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg, mesh)
    frames = {k: graphs._SHAPES[k][0] for k in _slotted()}
    assert len(frames) == 4
    for i in range(10, 18):
        graphs.run_shape(("single", i), object)
    render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg, mesh)
    assert {k: graphs._SHAPES[k][0] for k in _slotted()} == frames
    assert len(graphs._SHAPES) == 8 + 4
    graphs.clear()


def test_mesh_gives_a_cuda_device_its_index(monkeypatch):
    """A mesh entry "cuda" is the current CUDA device with its index, so
    it is the same device as a scene's "cuda:0" (and takes no copy)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = par.Mesh([["cuda", "cuda:1"], ["cpu", torch.device("cuda")]])
    assert list(mesh.devices.flat) == [
        torch.device("cuda", 0), torch.device("cuda", 1),
        torch.device("cpu"), torch.device("cuda", 0)]


def test_shard_streams_are_distinct_and_kept(monkeypatch):
    """Each shard of a card gets a stream no other shard of it has, drawn
    from torch's round-robin pool (here a stand-in of 32 entries that
    other callers also draw from) and the same at every call; past the
    pool's distinct streams it raises rather than share one."""
    drawn = iter(range(10 ** 6))

    class PoolStream:
        def __init__(self, device):
            self.cuda_stream = next(drawn) % 32

    monkeypatch.setattr(torch.cuda, "Stream", PoolStream)
    monkeypatch.setattr(par.sharding, "_STREAMS", {})
    dev = torch.device("cuda", 0)
    first = [par.sharding._stream(dev, k) for k in range(4)]
    assert len({s.cuda_stream for s in first}) == 4
    for _ in range(30):  # others draw meanwhile: the pool wraps
        PoolStream(dev)
    assert [par.sharding._stream(dev, k) for k in range(4)] == first
    every = [par.sharding._stream(dev, k) for k in range(32)]
    assert len({s.cuda_stream for s in every}) == 32
    with pytest.raises(RuntimeError, match="distinct streams"):
        par.sharding._stream(dev, 32)


def test_counts_read_each_live_count_and_copy(setup, monkeypatch):
    """graphs.COUNTS over a sharded call: one read for each live-count
    read of the rounds, no capture or replay on the CPU, no copy for a
    mesh of the scene's own device."""
    scene, lens, cfg = setup
    reads = []
    real = P._Trace.live_count
    monkeypatch.setattr(P._Trace, "live_count",
                        lambda tr: reads.append(1) or real(tr))
    graphs.reset_counts()
    render_sharded(scene, lens_arrays(lens), 16, 16, 4,
                   replace(cfg, unroll=False), make_mesh(CPU8[:4], sp=2))
    assert graphs.COUNTS == {"captures": 0, "replays": 0,
                             "reads": len(reads), "copies": 0}
    assert len(reads) > 0


def test_a_failing_shard_raises(setup, monkeypatch):
    """A shard whose step raises makes render_sharded raise (no quiet
    fallback); the other shards' frames are released, so the next call
    renders the same image as before."""
    scene, lens, cfg = setup
    mesh = make_mesh(CPU8[:4], sp=2)
    want, _ = render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg, mesh)
    raygen = RR._Frame.raygen

    def failing(frame):
        if frame.y0 == 8:
            raise RuntimeError("shard failed")
        raygen(frame)

    monkeypatch.setattr(RR._Frame, "raygen", failing)
    with pytest.raises(RuntimeError, match="shard failed"):
        render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg, mesh)
    monkeypatch.setattr(RR._Frame, "raygen", raygen)
    got, _ = render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg, mesh)
    assert torch.equal(got, want)


def sphere_engine(mesh_spec=None):
    e = Engine(PathConfig(max_bounces=2, env_samples_per_bounce=0,
                          mesh_samples_per_bounce=0, unroll=False),
               device="cpu")
    sphere = icosphere(1, with_normals=False)
    mesh_h = e.create_mesh(sphere.positions, sphere.indices)
    white = e.create_solid_texture([1.0, 1.0, 1.0])
    black = e.create_solid_texture([0.0, 0.0, 0.0])
    one = e.create_solid_texture(1.0)
    zero = e.create_solid_texture(0.0)
    mat = e.create_material(color=white, metalness=zero, roughness=one,
                            emissive=black)
    e.create_instance(translate(0, 0, 0), [(mesh_h, mat, False)])
    e.set_background(None)
    if mesh_spec is not None:
        e.set_mesh(mesh_spec)
    return e


class TestEngineMesh:
    @pytest.mark.parametrize("spec", ["2,4", "mesh"])
    def test_engine_render_on_mesh(self, spec):
        e1 = sphere_engine()
        s1, l1 = e1.create_sensor(16, 16), e1.create_lens(outside_lens())
        e1.render(s1, l1, spp=4)
        want = e1.get_sensor_data(s1)
        e2 = sphere_engine(make_mesh(CPU8, sp=2) if spec == "mesh" else spec)
        s2, l2 = e2.create_sensor(16, 16), e2.create_lens(outside_lens())
        e2.render(s2, l2, spp=4)
        np.testing.assert_allclose(e2.get_sensor_data(s2), want, atol=2e-6)
        assert e2.metrics["rays"] == e1.metrics["rays"]
        with pytest.warns(RuntimeWarning, match="single-device"):
            e2.render(s2, l2, spp=3)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            e2.render(s2, l2, spp=3)
        assert e2.sample_count(s2) == 10

    def test_set_mesh_rejects_bad_axes(self):
        class Bad:
            axis_names = ("a", "b")
            shape = {"a": 2, "b": 4}

        with pytest.raises(ValueError, match="sp"):
            Engine(device="cpu").set_mesh(Bad())


def test_viewer_reaches_render_sharded(monkeypatch):
    calls = {"n": 0}
    real = par.render_sharded

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(par, "render_sharded", counting)
    v = Viewer(sphere_engine(), outside_lens(), width=16, height=16,
               mesh="2,4")
    v.step()
    assert calls["n"] == 1
    assert v.status()["mesh"] == {"sp": 2, "dp": 4}
    assert v.status()["samples"] == 2


def test_cli_mesh(tmp_path, capsys):
    """The Cornell glb through both CLIs with --mesh 2,4 (48x32, 2 spp,
    max bounces 1024): the port's against the JAX CLI's sharded image
    (the image gate) and its own unsharded one (2e-6)."""
    from glb_builder import cornell_box_glb
    from moonshine_tpu.io.exr import read_exr as jax_read_exr
    from moonshine_tpu.render import offline as JO
    from moonshine_tpu_torch.io.exr import read_exr, write_exr
    from moonshine_tpu_torch.render import offline as PO

    (tmp_path / "c.glb").write_bytes(cornell_box_glb())
    write_exr(tmp_path / "sky.exr", np.full((4, 8, 3), 0.25, np.float32))
    args = [str(tmp_path / "c.glb"), str(tmp_path / "sky.exr")]
    size = ["--width", "48", "--height", "32", "--spp", "2"]
    mesh = ["--mesh", "2,4"]
    assert JO.main(args + [str(tmp_path / "j.exr")] + size + mesh) == 0
    assert PO.main(args + [str(tmp_path / "p.exr")] + size + mesh,
                   device="cpu") == 0
    out = capsys.readouterr().out
    assert "render 2 spp on mesh sp=2 dp=4" in out
    assert PO.main(args + [str(tmp_path / "q.exr")] + size,
                   device="cpu") == 0
    got = read_exr(tmp_path / "p.exr")[..., :3]
    assert_image_close(got, jax_read_exr(tmp_path / "j.exr")[..., :3])
    np.testing.assert_allclose(got, read_exr(tmp_path / "q.exr")[..., :3],
                               atol=2e-6)
