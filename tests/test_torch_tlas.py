"""Two-level instancing in the port (accel/tlas.py, scene/world.py's
two-level build, the decode in integrator/path.py) against
moonshine_tpu's, on the CPU, where the wrappers run their plain versions
(the CUDA kernel of csrc/tlas.cu is held to those bit for bit by the
`cuda` tests and chip_smoke.py).

Tolerances: the host builds (the TLAS arrays, shading rows, instance
transforms, emitter rows) are equal exactly. Traversal of the same
arrays: tri, inst and is_hit equal; t within 1e-6 relative, u and v
within 1e-5 absolute (the reference's object-space transform is an
einsum, which XLA may contract into fused multiply-adds, the port's a
written-out sum of separately rounded products, so the object-space ray
may differ in its last bits, which the barycentrics of a hit carry a few
ulps further). Images against the JAX
package's two-level render: >= 99% of pixels within 1e-3 (absolute plus
relative) and means within 1e-3 relative, the port's image bar; the
two-level against the flattened render: the reference's own bounds
(tests/test_tlas.py), >= 99.5% of values within 5e-3 and means within
2e-3 relative. Mirrors tests/test_tlas.py case for case."""

import os

import numpy as np
import pytest
import torch

from moonshine_tpu.accel import tlas as JT
from moonshine_tpu.scene import types as JTy
from moonshine_tpu.scene.world import World as JWorld
from moonshine_tpu_torch.accel import tlas as PT
from moonshine_tpu_torch.accel import traverse
from moonshine_tpu_torch.engine.engine import Engine
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.render.renderer import render_spp
from moonshine_tpu_torch.scene import types as PTy
from moonshine_tpu_torch.scene.world import (
    World, _flatten_object, _world_flat, scene_from_arrays,
)

from fixtures import icosphere
from test_torch_incremental import port_mesh
from test_torch_scene import ENV_KEYS, ENV_TOL

INF_T = 1.0e12
CFG = dict(max_bounces=3)


def instanced_world(T=PTy, cls=World, mesh=port_mesh, n=5, emissive=True,
                    mirrored=False, hidden=None):
    """tests/test_tlas.py's instanced_world in either package: n instances
    of one icosphere(2) (a rotation, a non-uniform scale, optionally a
    mirror), a floor and an optional emissive quad."""
    w = cls()
    sphere = w.add_mesh(mesh(icosphere(2)))
    floor = w.add_mesh(T.Mesh(
        positions=np.float32([[-20, -20, -2], [20, -20, -2], [20, 20, -2],
                              [-20, 20, -2]]),
        indices=np.uint32([[0, 1, 2], [0, 2, 3]])))
    red = w.add_material(T.MaterialInfo(variant=T.Lambert(
        color=(0.8, 0.2, 0.2))))
    grey = w.add_material(T.MaterialInfo(variant=T.Lambert(
        color=(0.6, 0.6, 0.6))))
    rng = np.random.RandomState(3)
    for i in range(n):
        m = np.zeros((3, 4), np.float32)
        if i == 1:
            c, s = np.cos(0.7), np.sin(0.7)
            m[:, :3] = np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        elif i == 2:
            m[:, :3] = np.diag([0.5, 1.3, 0.8]).astype(np.float32)
        elif i == 3 and mirrored:
            m[:, :3] = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
        else:
            m[:, :3] = np.eye(3, dtype=np.float32)
        m[:, 3] = rng.uniform(-4, 4, 3).astype(np.float32)
        m[2, 3] = abs(m[2, 3]) * 0.25
        w.add_instance(T.Instance(transform=m,
                                  geometries=[T.Geometry(sphere, red)],
                                  visible=hidden is None or i != hidden))
    w.add_instance(T.Instance(transform=T.identity_transform(),
                              geometries=[T.Geometry(floor, grey)]))
    if emissive:
        quad = w.add_mesh(T.Mesh(
            positions=np.float32([[-1, -1, 6], [1, -1, 6], [1, 1, 6],
                                  [-1, 1, 6]]),
            indices=np.uint32([[0, 2, 1], [0, 3, 2]])))
        lamp = w.add_material(T.MaterialInfo(
            variant=T.Lambert(color=(0, 0, 0)), emissive=(8.0, 8.0, 8.0)))
        w.add_instance(T.Instance(transform=T.translate(0, 0, 0),
                                  geometries=[T.Geometry(quad, lamp,
                                                         sampled=True)]))
    w.set_background(np.full((8, 16, 3), 0.4, np.float32), size=8)
    return w


def jax_world(**kw):
    return instanced_world(JTy, JWorld, lambda m: m, **kw)


LENS = dict(origin=np.float32([0, -12, 2]), forward=np.float32([0, 1, -0.1]),
            up=np.float32([0, 0, 1]), vfov=np.pi / 4)


def two_level(build, *args):
    """build(*args) under MSN_FORCE_TLAS=1."""
    os.environ["MSN_FORCE_TLAS"] = "1"
    try:
        return build(*args)
    finally:
        del os.environ["MSN_FORCE_TLAS"]


def jax_tlas_arrays(js):
    """A JAX two-level DeviceScene as scene_from_arrays' dicts."""
    import jax.numpy as jnp

    f = np.asarray
    atlas = js.mat_atlas
    arrays = {f"tlas.{k}": f(getattr(js.tlas, k)) for k in PT.ARRAY_FIELDS}
    arrays.update({
        "inst_tf": f(js.inst_tf), "tri_shade": f(js.tri_shade),
        "materials.packed": f(js.materials.packed),
        "mat_atlas.bsdf.data": f(atlas.bsdf.data.astype(jnp.float32)),
        "mat_atlas.emissive.data": f(atlas.emissive.data.astype(
            jnp.float32)),
        "env.rgbl": f(js.env.rgbl), "env.select": f(js.env.select),
        "env.alias": f(js.env.alias).astype(np.int64),
        "emitters.select": f(js.emitters.select),
        "emitters.alias": f(js.emitters.alias).astype(np.int64),
        "emitters.tri": f(js.emitters.tri).astype(np.int64),
        "emitters.rows": f(js.emitters.rows),
    })
    statics = {
        "tlas.num_instances": js.tlas.num_instances,
        "tlas.num_obj_tris": js.tlas.num_obj_tris,
        "mat_atlas.bsdf.width": int(atlas.bsdf.width),
        "mat_atlas.bsdf.chunks": atlas.bsdf.chunks_token.shape[0],
        "mat_atlas.emissive.width": int(atlas.emissive.width),
        "mat_atlas.emissive.chunks": atlas.emissive.chunks_token.shape[0],
        "mat_atlas.bsdf_constant": atlas.bsdf_constant,
        "mat_atlas.emissive_constant": atlas.emissive_constant,
        "mat_atlas.normals_flat": atlas.normals_flat,
        "env.integral": float(js.env.integral),
        "emitters.count": int(js.emitters.count),
        "emitters.weight_sum": float(js.emitters.weight_sum),
        "has_delta": js.has_delta,
    }
    return arrays, statics


def rays(n, seed):
    """tests/test_tlas.py's rays: from the camera plane y = -12, forward."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 1] = -12.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def flat_world_verts(w):
    """The port's world-space triangles of the visible instances."""
    cache = _flatten_object(w.meshes, w.instances)
    verts = _world_flat(cache, w.instances)["verts"]
    vis = np.ones(len(verts), bool)
    for inst, (s, e) in zip(w.instances, cache["slices"]):
        vis[s:e] = inst.visible
    return verts[vis]


def port_render(scene, size=48, spp=2):
    la = LensArrays.from_lens(PTy.Lens(**LENS), "cpu")
    img, _ = render_spp(scene, la, size, size, 0, spp, PathConfig(**CFG))
    return img.numpy() / spp


def jax_render(scene, size=48, spp=2):
    from moonshine_tpu.integrator import PathConfig as JCfg
    from moonshine_tpu.render.camera import LensArrays as JLens
    from moonshine_tpu.render.renderer import render_spp as jax_render_spp

    img, _ = jax_render_spp(scene, JLens.from_lens(JTy.Lens(**LENS)), size,
                            size, 0, spp, JCfg(**CFG))
    return np.asarray(img) / spp


# --- the host build ---

def test_build_tlas_matches_reference():
    """build_tlas: every TLAS array and the object-space flatten equal the
    reference's (power-of-two padding, absolute links, the hidden
    instance's root and point box, the top level's leaf order)."""
    w = jax_world(n=6, mirrored=True, hidden=4)
    want, want_obj, want_groups = JT.build_tlas(w.meshes, w.instances)
    pw = instanced_world(n=6, mirrored=True, hidden=4)
    got, got_obj, got_groups = PT.build_tlas(pw.meshes, pw.instances)
    for k in PT.ARRAY_FIELDS:
        a, b = np.asarray(getattr(want, k)), np.asarray(getattr(got, k))
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=k)
    assert (got.num_instances, got.num_obj_tris) == (want.num_instances,
                                                     want.num_obj_tris)
    for k, a in want_obj.items():
        np.testing.assert_array_equal(got_obj[k], np.asarray(a), err_msg=k)
    assert got_groups == want_groups


def test_two_level_scene_matches_reference():
    """World.build under MSN_FORCE_TLAS against the JAX World's two-level
    scene: shading rows (column 26 = -1), inst_tf, the TLAS, materials,
    emitters (the visible sampled geometry only), env."""
    js = two_level(jax_world(n=6, mirrored=True, hidden=4).build)
    want, want_s = jax_tlas_arrays(js)
    pw = instanced_world(n=6, mirrored=True, hidden=4)
    got, got_s = two_level(pw.build_arrays)
    assert set(got) == set(want)
    for k, a in want.items():
        if k.startswith("mat_atlas."):  # the device planes are bf16
            got[k] = torch.tensor(got[k]).to(torch.bfloat16).float().numpy()
        if k in ENV_KEYS:
            np.testing.assert_allclose(got[k], a, **ENV_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          a.astype(np.asarray(got[k]).dtype),
                                          err_msg=k)
    assert (got["tri_shade"][:, 26] == -1).all()
    for k, v in want_s.items():
        if k == "env.integral":
            assert got_s[k] == pytest.approx(v, rel=1e-6)
        else:
            assert got_s[k] == v, k
    scene = two_level(pw.build, "cpu")
    assert scene.wide is None and scene.tlas is not None
    assert scene.tlas.num_instances == 8


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_walk_matches_reference(kind):
    """The plain walks against moonshine_tpu.accel.tlas on the JAX
    scene's arrays (through scene_from_arrays): tri, inst and is_hit
    equal; t within 1e-6 relative, u and v within 1e-5 absolute;
    occlusion equal."""
    js = two_level(jax_world(n=6, mirrored=True).build)
    scene = scene_from_arrays(*jax_tlas_arrays(js), "cpu")
    o, d = rays(512, 11)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    active = torch.from_numpy(np.arange(512) % 7 != 3)
    if kind == "any":
        for t_max in (14.0, INF_T):
            want = np.asarray(JT.any_hit_tlas(js.tlas, o, d, t_max,
                                              active_in=active.numpy()))
            got = PT.any_hit_tlas_plain(scene.tlas, ot, dt, t_max,
                                        active_in=active)
            np.testing.assert_array_equal(got.numpy(), want)
            assert 0 < want.sum() < 512
        return
    want = JT.closest_hit_tlas(js.tlas, o, d, INF_T,
                               active_in=active.numpy())
    got = PT.closest_hit_tlas_plain(scene.tlas, ot, dt, INF_T,
                                    active_in=active)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.inst.numpy(), np.asarray(want.inst))
    assert got.is_hit.sum() > 100
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=1e-6, atol=0.0)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0.0, atol=1e-5, err_msg=name)


# --- mirrors of tests/test_tlas.py ---

def test_closest_matches_brute_force():
    w = instanced_world(n=6, mirrored=True)
    scene = two_level(w.build, "cpu")
    o, d = rays(256, 11)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = PT.closest_hit_tlas(scene.tlas, ot, dt, INF_T)
    want = traverse.brute_force_closest(
        torch.from_numpy(flat_world_verts(w)), ot, dt, INF_T)
    np.testing.assert_array_equal(got.is_hit.numpy(), want.is_hit.numpy())
    hit = want.is_hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[hit], want.t.numpy()[hit],
                               rtol=2e-4, atol=1e-4)
    assert (got.inst.numpy()[hit] >= 0).all()


def test_anyhit_matches_brute_force():
    w = instanced_world(n=6)
    scene = two_level(w.build, "cpu")
    o, d = rays(256, 12)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = PT.any_hit_tlas(scene.tlas, ot, dt, 14.0)
    want = traverse.brute_force_closest(
        torch.from_numpy(flat_world_verts(w)), ot, dt, 14.0).is_hit
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_hidden_instance_never_hit():
    scene = two_level(instanced_world(n=4, emissive=False, hidden=2).build,
                      "cpu")
    o, d = rays(128, 13)
    got = PT.closest_hit_tlas(scene.tlas, torch.from_numpy(o),
                              torch.from_numpy(d), INF_T)
    assert not (got.inst == 2).any()
    assert got.is_hit.any()


def test_respects_active_mask():
    scene = two_level(instanced_world(n=3, emissive=False).build, "cpu")
    o = torch.zeros((64, 3))
    o[:, 1] = -12.0
    d = torch.zeros((64, 3))
    d[:, 1] = 1.0
    active = torch.arange(64) % 2 == 0
    got = PT.closest_hit_tlas(scene.tlas, o, d, INF_T, active_in=active)
    assert (got.tri[~active] == -1).all() and (got.inst[~active] == -1).all()
    assert (got.t[~active] == INF_T).all()
    occ = PT.any_hit_tlas(scene.tlas, o, d, INF_T, active_in=active)
    assert not occ[~active].any()


def test_image_matches_jax_two_level_render():
    """The port's two-level render against the JAX package's (48x48 x 2
    spp, 3 bounces, mirrored and hidden instances, NEE on the quad)."""
    want = jax_render(two_level(jax_world(n=5, mirrored=True,
                                          hidden=4).build))
    got = port_render(two_level(instanced_world(n=5, mirrored=True,
                                                hidden=4).build, "cpu"))
    pix = (np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)).all(-1)
    assert pix.mean() >= 0.99, pix.mean()
    assert abs(got.mean() / want.mean() - 1.0) <= 1e-3


@pytest.mark.parametrize("case", ["mirrored", "hidden"])
def test_image_matches_flattened(case):
    """Two-level against flattened in the port: the same surfaces from
    the same RNG streams (the reference's bounds)."""
    kw = (dict(n=5, mirrored=True) if case == "mirrored"
          else dict(n=4, emissive=False, hidden=1))
    ref = port_render(instanced_world(**kw).build("cpu"))
    scene = two_level(instanced_world(**kw).build, "cpu")
    assert scene.tlas is not None
    img = port_render(scene)
    close = np.isclose(img, ref, rtol=5e-3, atol=5e-3)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=2e-3)


def test_cap_switches_to_tlas_with_warning(monkeypatch):
    monkeypatch.setenv("MSN_MAX_FLAT_TRIS", "100")
    w = instanced_world(n=5)
    with pytest.warns(UserWarning, match="two-level instancing"):
        scene = w.build("cpu")
    assert scene.tlas is not None and scene.wide is None
    img = port_render(scene)
    assert np.isfinite(img).all() and img.mean() > 0.0


def test_blas_dedup_shares_storage():
    """1000 instances of one mesh keep one mesh's rows."""
    w = World()
    sphere = w.add_mesh(port_mesh(icosphere(2)))
    red = w.add_material(PTy.MaterialInfo(variant=PTy.Lambert(
        color=(0.8, 0.2, 0.2))))
    rng = np.random.RandomState(5)
    for _ in range(1000):
        x, y, z = rng.uniform(-50, 50, 3)
        w.add_instance(PTy.Instance(transform=PTy.translate(x, y, z),
                                    geometries=[PTy.Geometry(sphere, red)]))
    w.set_background(np.full((4, 8, 3), 0.3, np.float32), size=4)
    scene = two_level(w.build, "cpu")
    n_mesh_tris = len(w.meshes[sphere].indices)
    assert scene.tri_shade.shape[0] == n_mesh_tris
    assert scene.tlas.num_instances == 1000
    assert scene.tlas.blas_tris.shape[0] == n_mesh_tris
    img = port_render(scene, size=32, spp=1)
    assert np.isfinite(img).all()


def test_pick_reports_instance():
    eng = Engine(device="cpu")
    w = World()
    sphere = w.add_mesh(port_mesh(icosphere(2)))
    red = w.add_material(PTy.MaterialInfo(variant=PTy.Lambert(
        color=(0.8, 0.2, 0.2))))
    w.add_instance(PTy.Instance(transform=PTy.translate(5, 0, 0),
                                geometries=[PTy.Geometry(sphere, red)]))
    w.add_instance(PTy.Instance(transform=PTy.identity_transform(),
                                geometries=[PTy.Geometry(sphere, red)]))
    w.set_background(np.full((4, 8, 3), 0.3, np.float32), size=4)
    eng.world = w
    lens = eng.create_lens(PTy.Lens(
        origin=np.float32([0, -6, 0]), forward=np.float32([0, 1, 0]),
        up=np.float32([0, 0, 1]), vfov=np.pi / 4))
    res = two_level(eng.pick, lens, 64, 64, 32, 32)
    assert eng._scene.tlas is not None
    assert res.instance == 1 and res.primitive >= 0


def test_transform_edit_rebuilds_two_level_scene():
    """A transform edit on a two-level world rebuilds it in full, as the
    reference's does: its arrays equal the JAX World's after the same
    edit, and a material edit refolds the shading rows in place."""
    jw, pw = jax_world(n=4), instanced_world(n=4)
    two_level(jw.build)
    first = two_level(pw.build, "cpu")
    m = PTy.translate(1.5, 0.5, 0.25)
    jw.set_transform(0, m)
    pw.set_transform(0, m)
    js = two_level(jw.build)
    got = two_level(pw.build, "cpu")
    assert got is not first and got.tlas is not None
    want, _ = jax_tlas_arrays(js)
    for k in PT.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got.tlas, k).numpy(),
                                      want[f"tlas.{k}"], err_msg=k)
    np.testing.assert_array_equal(got.inst_tf.numpy(), want["inst_tf"])
    mat = PTy.MaterialInfo(variant=PTy.Lambert(color=(0.1, 0.9, 0.1)))
    pw.update_material(0, mat)
    edited = two_level(pw.build, "cpu")
    assert edited.tlas is got.tlas
    np.testing.assert_array_equal(edited.tri_shade[:, 33:36].numpy()[0],
                                  np.float32([0.1, 0.9, 0.1]))
