"""The port's progressive Engine (engine/engine.py), mirroring
tests/test_engine.py case for case on the CPU, plus: its frames against
the JAX Engine's on the same fixture (the image gate of PERF.md §2: >=
99% of pixels within 1e-3 abs + rel, means within 1e-3 relative), and
checkpoints that each package loads from the other."""

import inspect
import threading
import time

import numpy as np
import pytest

from moonshine_tpu.engine import Engine as JaxEngine
from moonshine_tpu.integrator import PathConfig as JaxPathConfig
from moonshine_tpu_torch.engine import Engine
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.scene.types import Lens, translate

from fixtures import icosphere
from test_torch_render import assert_image_close

CFG = dict(max_bounces=4, env_samples_per_bounce=0,
           mesh_samples_per_bounce=0, unroll=False)


def populate(e, albedo=(1.0, 1.0, 1.0), subdivisions=2):
    sphere = icosphere(subdivisions, with_normals=False)
    mesh = e.create_mesh(sphere.positions, sphere.indices)
    white = e.create_solid_texture(list(albedo))
    black = e.create_solid_texture([0.0, 0.0, 0.0])
    one = e.create_solid_texture(1.0)
    zero = e.create_solid_texture(0.0)
    mat = e.create_material(color=white, metalness=zero, roughness=one,
                            emissive=black)
    inst = e.create_instance(translate(0, 0, 0), [(mesh, mat, False)])
    e.set_background(None)
    e.fixture = dict(mesh=mesh, mat=mat, inst=inst, white=white,
                     black=black, one=one, zero=zero)
    return e


@pytest.fixture()
def engine():
    return populate(Engine(PathConfig(**CFG), device="cpu"))


def front_lens():
    return Lens(origin=np.float32([0, -3, 0]), forward=np.float32([0, 1, 0]),
                up=np.float32([0, 0, 1]), vfov=np.pi / 4)


class TestEngine:
    def test_progressive_accumulation_white_furnace(self, engine):
        sensor = engine.create_sensor(16, 16)
        lens = engine.create_lens(front_lens())
        for _ in range(3):
            img = engine.render(sensor, lens)
        assert engine.sample_count(sensor) == 3
        assert abs(img[..., :3].mean() - 1.0) < 0.05
        assert (img[..., 3] == 1.0).all()
        assert np.isfinite(img).all()

    def test_reset_sensor(self, engine):
        sensor = engine.create_sensor(8, 8)
        lens = engine.create_lens(front_lens())
        engine.render(sensor, lens)
        engine.reset_sensor(sensor)
        assert engine.sample_count(sensor) == 0

    def test_material_edit_changes_image(self, engine):
        sensor = engine.create_sensor(12, 12)
        lens = engine.create_lens(front_lens())
        img_white = engine.render(sensor, lens).copy()
        grey = engine.create_solid_texture([0.2, 0.2, 0.2])
        scene = engine._scene
        engine.set_material_color(engine.fixture["mat"], grey)
        engine.reset_sensor(sensor)
        img_grey = engine.render(sensor, lens)
        center = (slice(4, 8), slice(4, 8))
        assert img_grey[center][..., 0].mean() < img_white[center][..., 0].mean()
        assert engine._scene.wide is scene.wide  # a material-only rebuild

    def test_visibility_edit(self, engine):
        sensor = engine.create_sensor(12, 12)
        lens = engine.create_lens(front_lens())
        engine.set_instance_visibility(engine.fixture["inst"], False)
        img = engine.render(sensor, lens)
        assert np.allclose(img[..., :3], 1.0, atol=1e-6)

    def test_transform_edit_and_pick(self, engine):
        lens = engine.create_lens(front_lens())
        hit = engine.pick(lens, 32, 32, 16, 16)
        assert hit.hit and hit.instance == engine.fixture["inst"]
        assert hit.geometry == 0 and hit.primitive >= 0
        assert not engine.pick(lens, 32, 32, 0, 0).hit
        scene = engine._scene
        engine.set_instance_transform(engine.fixture["inst"],
                                      translate(10, 0, 0))
        assert not engine.pick(lens, 32, 32, 16, 16).hit
        assert engine._scene.bvh.tri_order is scene.bvh.tri_order  # a refit

    def test_checkpoint_roundtrip(self, engine, tmp_path):
        sensor = engine.create_sensor(8, 8)
        lens = engine.create_lens(front_lens())
        engine.render(sensor, lens)
        engine.render(sensor, lens)
        path = tmp_path / "ckpt.npz"
        engine.save_checkpoint(path, sensor)
        img_before = engine.get_sensor_data(sensor)
        other = Engine(engine.config, device="cpu")
        s2 = other.create_sensor(8, 8)
        other.load_checkpoint(path, s2)
        assert other.sample_count(s2) == 2
        np.testing.assert_array_equal(other.get_sensor_data(s2), img_before)

    def test_metrics(self, engine):
        sensor = engine.create_sensor(8, 8)
        lens = engine.create_lens(front_lens())
        engine.render(sensor, lens)
        assert engine.metrics["renders"] == 1
        assert engine.metrics["rays"] > 0
        assert engine.metrics["last_mrays_per_sec"] > 0

    def test_set_config_rejits(self, engine):
        sensor = engine.create_sensor(8, 8)
        lens = engine.create_lens(front_lens())
        engine.render(sensor, lens)
        engine.set_config(PathConfig(max_bounces=2, env_samples_per_bounce=0,
                                     mesh_samples_per_bounce=0, unroll=False))
        engine.reset_sensor(sensor)
        img = engine.render(sensor, lens)
        assert np.isfinite(img).all()

    def test_wait_false_accounts_rays_later(self, engine):
        sensor = engine.create_sensor(8, 8)
        lens = engine.create_lens(front_lens())
        assert engine.render(sensor, lens, wait=False) is None
        assert engine.metrics["rays"] == 0.0
        engine.render(sensor, lens)
        assert engine.sample_count(sensor) == 2
        assert engine.metrics["rays"] > 8 * 8 * 2 - 1

    def test_defaults_to_the_card(self):
        assert inspect.signature(Engine).parameters["device"].default == \
            "cuda"
        e = Engine()
        assert e.device.type == "cuda"
        assert (e.config.max_bounces, e.config.env_samples_per_bounce,
                e.config.mesh_samples_per_bounce) == (1024, 0, 0)


class TestRenderConcurrency:
    def test_pick_responsive_during_render(self, engine):
        sensor = engine.create_sensor(96, 96)
        lens = engine.create_lens(front_lens())
        engine.render(sensor, lens)
        started = threading.Event()
        done = threading.Event()

        def long_render():
            started.set()
            engine.render(sensor, lens, spp=6)
            done.set()

        t = threading.Thread(target=long_render)
        t.start()
        assert started.wait(timeout=60)
        t0 = time.perf_counter()
        hit = engine.pick(lens, 96, 96, 48, 48)
        pick_dt = time.perf_counter() - t0
        render_running = not done.is_set()
        t.join(timeout=300)
        assert not t.is_alive() and done.is_set()
        assert hit.hit
        if render_running:
            total = engine.metrics["last_frame_seconds"]
            assert pick_dt < max(0.75 * total, 1.0)

    def test_reset_during_render_discards_frame(self, engine):
        sensor = engine.create_sensor(32, 32)
        lens = engine.create_lens(front_lens())
        engine.render(sensor, lens)
        ready = threading.Event()
        orig_ensure = engine._ensure_scene

        def slow_ensure():
            scene = orig_ensure()
            ready.set()
            return scene

        engine._ensure_scene = slow_ensure
        t = threading.Thread(target=lambda: engine.render(sensor, lens))
        t.start()
        assert ready.wait(timeout=60)
        engine.reset_sensor(sensor)
        t.join(timeout=300)
        assert not t.is_alive()
        engine._ensure_scene = orig_ensure
        assert engine.sample_count(sensor) <= 1


# --- against the JAX Engine ---

def test_frames_match_jax_engine():
    """Three 1-spp frames at 24x16 on both Engines, with an edit between
    the second and third (a move: a refit in both), each frame's running
    mean within the image gate."""
    jcfg = JaxPathConfig(max_bounces=4, env_samples_per_bounce=0,
                         mesh_samples_per_bounce=0, unroll=False)
    je = populate(JaxEngine(jcfg), albedo=(0.6, 0.5, 0.4), subdivisions=1)
    pe = populate(Engine(PathConfig(**CFG), device="cpu"),
                  albedo=(0.6, 0.5, 0.4), subdivisions=1)
    sky = np.linspace(0.2, 2.0, 4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
    for e in (je, pe):
        e.set_background(sky)
        e.fixture["sensor"] = e.create_sensor(24, 16)
        e.fixture["lens"] = e.create_lens(front_lens())
    for frame in range(3):
        if frame == 2:
            for e in (je, pe):
                e.set_instance_transform(e.fixture["inst"],
                                         translate(0.3, 0.5, -0.2))
        want = je.render(je.fixture["sensor"], je.fixture["lens"])
        got = pe.render(pe.fixture["sensor"], pe.fixture["lens"])
        assert got.shape == want.shape == (16, 24, 4)
        assert_image_close(got[..., :3], np.asarray(want)[..., :3])
    assert je.sample_count(je.fixture["sensor"]) == \
        pe.sample_count(pe.fixture["sensor"]) == 3
    hit_j = je.pick(je.fixture["lens"], 24, 16, 12, 8)
    hit_p = pe.pick(pe.fixture["lens"], 24, 16, 12, 8)
    assert (hit_p.instance, hit_p.geometry) == (hit_j.instance,
                                                hit_j.geometry)
    np.testing.assert_allclose(hit_p.barycentrics, hit_j.barycentrics,
                               atol=1e-5)


def _set_sensor(engine, handle, img, count):
    """Put a known running mean into a sensor of either package."""
    if isinstance(engine, Engine):
        import torch

        engine.sensors[handle] = engine.sensors[handle]._replace(
            image=torch.from_numpy(img), sample_count=count)
    else:
        import jax.numpy as jnp

        engine.sensors[handle] = engine.sensors[handle]._replace(
            image=jnp.asarray(img), sample_count=jnp.asarray(count,
                                                             jnp.int32))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_load_across_packages(direction, tmp_path):
    """np.savez checkpoints: what one package saves the other loads, the
    running mean bit for bit and the sample count."""
    img = np.random.RandomState(1).rand(6, 10, 3).astype(np.float32)
    jax_e = JaxEngine(JaxPathConfig(max_bounces=1, unroll=False))
    port_e = Engine(device="cpu")
    src, dst = ((jax_e, port_e) if direction == "jax_to_port"
                else (port_e, jax_e))
    s_src, s_dst = src.create_sensor(10, 6), dst.create_sensor(10, 6)
    _set_sensor(src, s_src, img, 7)
    path = tmp_path / "ckpt.npz"
    src.save_checkpoint(path, s_src)
    dst.load_checkpoint(path, s_dst)
    assert dst.sample_count(s_dst) == 7
    np.testing.assert_array_equal(np.asarray(dst.get_sensor_data(s_dst))
                                  [..., :3], img)
