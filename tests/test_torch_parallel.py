"""The port's sharded render (parallel/sharding.py), mirroring
tests/test_parallel.py on a mesh of ["cpu"] * 8 (the executable-cache
case has no torch meaning and is left out): the sharded image equals the
port's single-device render within 2e-6 absolute (the reference test's
bar) on 2x4 and 8x1 meshes, staged or not, and the JAX package's
render_sharded on the conftest's 8-device CPU mesh within the image gate
of PERF.md §2; the Engine, the viewer and the CLI's --mesh reach it."""

import warnings

import numpy as np
import pytest
import torch

from moonshine_tpu_torch import parallel as par
from moonshine_tpu_torch.engine import Engine
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.parallel import (
    make_mesh, mesh_from_spec, render_sharded, visible_devices,
)
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
        """Every shard runs with its own device made current
        (`_current`), one after another, and the image is the same bit
        for bit as without the hook."""
        scene, lens, cfg = setup
        mesh = make_mesh(CPU8, sp=2)
        want, rays_want = render_sharded(scene, lens_arrays(lens), 16, 16, 4,
                                         cfg, mesh)
        entered = []
        real_current = par.sharding._current

        def current(device):
            entered.append(device)
            return real_current(device)

        monkeypatch.setattr(par.sharding, "_current", current)
        got, rays = render_sharded(scene, lens_arrays(lens), 16, 16, 4, cfg,
                                   mesh)
        assert torch.equal(got, want) and int(rays) == int(rays_want)
        assert entered == list(mesh.devices.flat)

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
