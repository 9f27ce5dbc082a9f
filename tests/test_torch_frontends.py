"""The port's small frontends against the reference, mirroring
tests/test_frontends.py:44-215 on the CPU: the direct-light integrator
(trace_direct) on the same rays and RNG states as the JAX one, ray for
ray (1e-5 absolute plus relative) on the JAX scene's arrays, on env and
mesh-light NEE, with a mirror in view; the
DisneyDiffuse lobe against the reference's functions; the viewer (keys,
accumulation cap, tonemap, the web server's frame and key round trip,
the edit panel, frames in flight); and encode_png read back by PIL.
(DDS is tests/test_torch_jpeg.py's.)"""

import io
import json
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from moonshine_tpu.bsdf import materials as JM
from moonshine_tpu.core import rng as JR
from moonshine_tpu.integrator.direct import DirectConfig as JDirectConfig
from moonshine_tpu.integrator.direct import trace_direct as jax_direct
from moonshine_tpu.render.camera import LensArrays as JaxLens
from moonshine_tpu.render.camera import generate_rays, pixel_uv
from moonshine_tpu.render.viewer import tonemap as jax_tonemap
from moonshine_tpu.scene import types as JT
from moonshine_tpu.scene.world import World as JWorld
from moonshine_tpu_torch.bsdf import materials as PM
from moonshine_tpu_torch.engine import Engine
from moonshine_tpu_torch.integrator.direct import DirectConfig, trace_direct
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.io.png import decode_png, encode_png
from moonshine_tpu_torch.render.viewer import Viewer, tonemap
from moonshine_tpu_torch.scene import types as PT
from moonshine_tpu_torch.scene.types import Lens, translate
from moonshine_tpu_torch.scene.world import World, scene_from_arrays

from fixtures import icosphere
from test_torch_incremental import port_mesh
from test_torch_scene import jax_scene_arrays


def lit_world(T, cls, mesh, mirror=False):
    """A 0.6-albedo sphere, a red emissive quad above it (NEE-sampled)
    and a sky with a bright band, in either package's types; `mirror`
    adds a mirror sphere beside the grey one."""
    w = cls()
    sphere = w.add_mesh(mesh(icosphere(2, with_normals=False)))
    quad = w.add_mesh(T.Mesh(
        positions=np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                              [-1, 1, 0]]),
        indices=np.uint32([[0, 2, 1], [0, 3, 2]])))
    grey = w.add_material(T.MaterialInfo(variant=T.Lambert(
        color=(0.6, 0.6, 0.6))))
    light = w.add_material(T.MaterialInfo(
        variant=T.Lambert(color=(0, 0, 0)), emissive=(4.0, 1.0, 0.5)))
    w.add_instance(T.Instance(transform=T.identity_transform(),
                              geometries=[T.Geometry(sphere, grey)]))
    w.add_instance(T.Instance(transform=T.translate(0, 0, 2.5),
                              geometries=[T.Geometry(quad, light,
                                                     sampled=True)]))
    if mirror:
        chrome = w.add_material(T.MaterialInfo(variant=T.Mirror()))
        w.add_instance(T.Instance(transform=T.translate(1.7, 0.5, 0),
                                  geometries=[T.Geometry(sphere, chrome)]))
    sky = np.full((8, 16, 3), 0.3, np.float32)
    sky[2:4] = 3.0
    w.set_background(sky)
    return w


def jax_rays(n_side=16):
    lens = JaxLens.from_lens(JT.Lens(
        origin=np.float32([0, -3, 0.5]), forward=np.float32([0, 1, -0.1]),
        up=np.float32([0, 0, 1]), vfov=np.pi / 3))
    N = n_side * n_side
    px = jnp.arange(N, dtype=jnp.uint32) % n_side
    py = jnp.arange(N, dtype=jnp.uint32) // n_side
    rng = JR.seed(0, px, py)
    rng, jit2 = JR.next_float2(rng)
    uv = pixel_uv(px, py, n_side, n_side, jit2, True)
    rng, ap = JR.next_float2(rng)
    o, d = generate_rays(lens, n_side, n_side, uv, ap)
    return o, d, rng


@pytest.mark.parametrize("env,mesh,mirror", [
    (1, 0, False), (0, 1, False), (2, 1, False), (1, 1, True)],
    ids=["1-0", "0-1", "2-1", "1-1-mirror"])
def test_trace_direct_matches_reference(env, mesh, mirror):
    """On the JAX World's scene loaded through scene_from_arrays, ray for
    ray: both then sample the same env alias table. (Each package builds
    its own from texels that agree to 1e-6; where texels tie, as in this
    sky's flat regions, the two tables pair them differently, so the same
    draw can land on another texel of the same distribution.) With a
    mirror in view, its hits trace their shadow rays and count them in
    the rays, as the reference's do, though their weight is 0."""
    js = JWorld.build(lit_world(JT, JWorld, lambda m: m, mirror))
    ps = scene_from_arrays(*jax_scene_arrays(js), "cpu")
    o, d, rng = jax_rays()
    if mirror:
        from moonshine_tpu_torch.integrator.path import _closest

        hit = _closest(ps, torch.tensor(np.asarray(o)),
                       torch.tensor(np.asarray(d)), 1e12, None)
        mat_type = ps.tri_shade[hit.tri.clamp_min(0).long(), 32]
        assert bool(((hit.tri >= 0) & (mat_type == 2)).any())
    want, want_rng, want_rays = jax_direct(js, o, d, rng, JDirectConfig(
        env_samples_per_bounce=env, mesh_samples_per_bounce=mesh))
    t = lambda x, dt=torch.float32: torch.tensor(np.asarray(x)).to(dt)
    got, got_rng, rays = trace_direct(
        ps, t(o), t(d), t(np.asarray(rng).astype(np.int64), torch.int64),
        DirectConfig(env_samples_per_bounce=env,
                     mesh_samples_per_bounce=mesh))
    want = np.asarray(want)
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_rng.numpy(),
                                  np.asarray(want_rng).astype(np.int64))
    assert int(rays) == int(float(want_rays)) > len(o)
    assert (want[:, 0] > 0).any() and (want == 0.3).any()  # lit and sky


def test_direct_background_is_exact():
    """The reference test's furnace case: a sphere under the constant
    white env with env NEE; background rays read exactly 1."""
    ps = World()
    sphere = ps.add_mesh(port_mesh(icosphere(3, with_normals=False)))
    mat = ps.add_material(PT.MaterialInfo(variant=PT.Lambert(
        color=(0.6, 0.6, 0.6))))
    ps.add_instance(PT.Instance(transform=PT.identity_transform(),
                                geometries=[PT.Geometry(sphere, mat)]))
    ps.set_background(None)
    o, d, rng = jax_rays()
    t = lambda x, dt=torch.float32: torch.tensor(np.asarray(x)).to(dt)
    rad, _, rays = trace_direct(ps.build("cpu"), t(o), t(d),
                                t(np.asarray(rng).astype(np.int64),
                                  torch.int64), DirectConfig(1, 0))
    rad = rad.numpy()
    assert np.isfinite(rad).all() and int(rays) > len(rad)
    assert (rad[:, 0] == 1.0).any()


# --- DisneyDiffuse ---

def _dirs(n, seed, upper=True):
    v = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return v


def test_disney_diffuse_matches_reference():
    w_o, w_i = _dirs(64, 1), _dirs(64, 2, upper=False)
    color = np.random.RandomState(3).rand(64, 3).astype(np.float32)
    rough = np.random.RandomState(4).rand(64).astype(np.float32)
    sq = np.random.RandomState(5).rand(64, 2).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_allclose(
        PM.disney_diffuse_eval(T(color), T(rough), T(w_i), T(w_o)).numpy(),
        np.asarray(JM.disney_diffuse_eval(color, rough, w_i, w_o)),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        PM.disney_diffuse_pdf(T(w_i), T(w_o)).numpy(),
        np.asarray(JM.disney_diffuse_pdf(w_i, w_o)), rtol=1e-6, atol=1e-7)
    wi_p, pdf_p = PM.disney_diffuse_sample(None, None, T(w_o), T(sq))
    wi_j, pdf_j = JM.disney_diffuse_sample(None, None, w_o, sq)
    np.testing.assert_allclose(wi_p.numpy(), np.asarray(wi_j), atol=1e-6)
    np.testing.assert_allclose(pdf_p.numpy(), np.asarray(pdf_j), atol=1e-6)
    np.testing.assert_allclose(pdf_p.numpy(),
                               PM.disney_diffuse_pdf(wi_p, T(w_o)).numpy(),
                               atol=1e-6)


def test_disney_energy_below_lambert_at_grazing():
    w_o = torch.tensor([[0.1, 0.0, 0.995]])
    w_o = w_o / w_o.norm()
    f = PM.disney_diffuse_eval(torch.ones(1, 3), torch.tensor([0.0]),
                               torch.tensor([[0.0, 0.0, 1.0]]), w_o)
    assert float(f[0, 0]) < 1.0 / np.pi


# --- viewer ---

def small_engine():
    e = Engine(PathConfig(max_bounces=2, env_samples_per_bounce=0,
                          mesh_samples_per_bounce=0, unroll=False),
               device="cpu")
    sphere = icosphere(1, with_normals=False)
    mesh = e.create_mesh(sphere.positions, sphere.indices)
    white = e.create_solid_texture([0.8, 0.8, 0.8])
    black = e.create_solid_texture([0.0, 0.0, 0.0])
    one = e.create_solid_texture(1.0)
    zero = e.create_solid_texture(0.0)
    mat = e.create_material(color=white, metalness=zero, roughness=one,
                            emissive=black)
    e.create_instance(translate(0, 0, 0), [(mesh, mat, False)])
    e.set_background(None)
    return e


def front_lens():
    return Lens(origin=np.float32([0, -3, 0]), forward=np.float32([0, 1, 0]),
                up=np.float32([0, 0, 1]), vfov=np.pi / 4)


def serve(v):
    """run_web on a free port in a daemon thread; returns the base URL."""
    t = threading.Thread(target=lambda: v.run_web(
        port=0, background_render=False), daemon=True)
    t.start()
    deadline = time.time() + 10
    while v.port is None and time.time() < deadline:
        time.sleep(0.05)
    base = f"http://127.0.0.1:{v.port}"
    while time.time() < deadline:
        try:
            urllib.request.urlopen(base + "/", timeout=2).read()
            return base
        except OSError:
            time.sleep(0.1)
    raise AssertionError("server never came up")


def post(base, path, body=None):
    req = urllib.request.Request(base + path, method="POST",
                                 data=json.dumps(body or {}).encode())
    return urllib.request.urlopen(req, timeout=60)


class TestViewer:
    def test_step_and_keys(self):
        v = Viewer(small_engine(), front_lens(), 8, 8)
        v.step()
        assert v.status()["samples"] == 1
        v.step()
        assert v.status()["samples"] == 2
        origin_before = np.asarray(v.lens.origin).copy()
        v.handle_key("w")
        assert v.status()["samples"] == 0
        assert not np.allclose(np.asarray(v.lens.origin), origin_before)
        v.step()
        png = v.frame_png()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(png))),
            tonemap(v.engine.get_sensor_data(v.sensor)))

    def test_turn_keeps_unit_forward(self):
        v = Viewer(small_engine(), front_lens(), 8, 8)
        for _ in range(5):
            v.handle_key("q")
        assert abs(np.linalg.norm(np.asarray(v.lens.forward)) - 1.0) < 1e-5

    def test_max_samples_cap(self):
        v = Viewer(small_engine(), front_lens(), 8, 8)
        v.max_samples = 2
        for _ in range(5):
            v.step()
        assert v.status()["samples"] == 2

    def test_web_server_roundtrip(self):
        v = Viewer(small_engine(), front_lens(), 8, 8)
        v.step()
        base = serve(v)
        try:
            page = urllib.request.urlopen(base + "/", timeout=5).read()
            assert b"moonshine_tpu_torch" in page
            frame = urllib.request.urlopen(base + "/frame.png",
                                           timeout=5).read()
            rgba = decode_png(frame)
            np.testing.assert_array_equal(
                rgba[..., :3], tonemap(v.engine.get_sensor_data(v.sensor)))
            assert post(base, "/key/w").status == 200
            assert v.status()["samples"] == 0
        finally:
            v.stop()

    def test_edit_panel_roundtrip(self):
        v = Viewer(small_engine(), front_lens(), 16, 16)
        v.step()
        base = serve(v)
        try:
            info = json.loads(post(base, "/pick", {"u": 0.5, "v": 0.5}).read())
            assert info["hit"] and info["instance"] == 0
            miss = json.loads(post(base, "/pick",
                                   {"u": 0.02, "v": 0.02}).read())
            assert not miss["hit"]
            post(base, "/pick", {"u": 0.5, "v": 0.5})
            post(base, "/edit/material", {"color": [1.0, 0.0, 0.0],
                                          "roughness": 1.0,
                                          "metalness": 0.0})
            v.step()
            center = v.engine.get_sensor_data(v.sensor)[8, 8, :3]
            assert center[0] > center[2] + 0.1
            post(base, "/edit/transform", {"delta": [100.0, 0.0, 0.0]})
            v.step()
            frame = v.engine.get_sensor_data(v.sensor)
            assert abs(frame[8, 8, :3].mean() - 1.0) < 1e-3
            post(base, "/edit/transform", {"delta": [-100.0, 0.0, 0.0]})
            post(base, "/edit/visibility", {"visible": False})
            v.step()
            frame = v.engine.get_sensor_data(v.sensor)
            assert abs(frame[8, 8, :3].mean() - 1.0) < 1e-3
            post(base, "/config", {"max_bounces": 3})
            assert v.engine.config.max_bounces == 3
            status = json.loads(urllib.request.urlopen(
                base + "/status", timeout=5).read())
            assert status["config"]["max_bounces"] == 3
        finally:
            v.stop()

    def test_async_frame_pipelining(self):
        v = Viewer(small_engine(), front_lens(), 8, 8)
        assert v.step(wait=False) is None
        assert v.step(wait=False) is None
        frame = v.step(wait=True)
        assert frame is not None
        assert v.engine.sample_count(v.sensor) == 3
        assert v.engine.metrics["rays"] > 0
        assert np.isfinite(frame).all()

    def test_tonemap(self):
        lin = np.zeros((2, 2, 4), np.float32)
        lin[..., :3] = [[[0.0, 0.5, 10.0]] * 2] * 2
        out = tonemap(lin)
        assert out.dtype == np.uint8
        assert out[0, 0, 0] == 0 and out[0, 0, 2] == 255
        assert 180 < out[0, 0, 1] < 195
        x = np.random.RandomState(0).rand(7, 9, 4).astype(np.float32) * 1.5
        np.testing.assert_array_equal(tonemap(x, 0.7), jax_tonemap(x, 0.7))


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 4), (33, 16, 4)])
def test_encode_png_read_back_by_pil(shape):
    px = np.random.RandomState(sum(shape)).randint(
        0, 256, shape).astype(np.uint8)
    png = encode_png(px)
    img = Image.open(io.BytesIO(png))
    assert img.mode == ("RGB" if shape[2] == 3 else "RGBA")
    np.testing.assert_array_equal(np.asarray(img), px)
    with pytest.raises(ValueError):
        encode_png(px[..., 0])
