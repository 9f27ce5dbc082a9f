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


# --- the kernel's walk and its tie rule (csrc/tlas.cu) ---

def _skip_link_leaves(left, count, escape, root):
    """The first slots of the leaves in the order the reference's
    skip-link walk meets them when every box passes."""
    out, cur = [], int(root)
    while cur >= 0:
        if count[cur] > 0:
            out.append(int(left[cur]))
            cur = int(escape[cur])
        else:
            cur = int(left[cur])
    return out


def _blas_roots(t):
    return sorted({int(r) for r in np.asarray(t.inst_root) if r >= 0})


def test_reference_walk_meets_leaves_in_rising_order():
    """The premise of the kernel's tie rule: on the reference's build_tlas
    of a scene of several geometry groups with a hidden instance, the
    reference's walk meets the leaves in rising order of their first slot
    on the top level and in every BLAS; every internal box holds its two
    children's (the right child the left one's escape), so a wide node
    may skip the binary boxes between it and its children."""
    w = jax_world(n=6, mirrored=True, hidden=4)
    t, _, groups = JT.build_tlas(w.meshes, w.instances)
    f = lambda k: np.asarray(getattr(t, k))
    levels = [("top", [0])] + [("blas", _blas_roots(t))]
    assert len(groups) >= 2 and (f("inst_root") == -1).sum() == 1
    for prefix, roots in levels:
        left, count, esc = (f(f"{prefix}_left"), f(f"{prefix}_count"),
                            f(f"{prefix}_escape"))
        mn, mx = f(f"{prefix}_min"), f(f"{prefix}_max")
        orders = [_skip_link_leaves(left, count, esc, r) for r in roots]
        for order in orders:
            assert order == sorted(set(order)), prefix
        assert max(len(x) for x in orders) > 1, prefix
        reach = np.zeros(len(left), bool)
        for root in roots:  # the nodes the walks can reach
            stack = [root]
            while stack:
                n = stack.pop()
                reach[n] = True
                if count[n] == 0:
                    stack += [left[n], esc[left[n]]]
        inner = np.nonzero(reach & (count == 0))[0]
        for child in (left[inner], esc[left[inner]]):
            assert (mn[inner] <= mn[child]).all() and \
                (mx[inner] >= mx[child]).all(), prefix


def _wide_leaves(nodes, node):
    """Leaf codes under a wide node, children in order."""
    codes = nodes[node, :, 3].copy().view(np.int32)
    out = []
    for c in codes:
        if c >= 0:
            out += _wide_leaves(nodes, c)
        elif c <= -2:
            out.append(int(c))
    return out


def test_walk_records_keep_the_reference_order():
    """build_walk: the 8-wide nodes hold the binary leaves in the
    reference walk's order (the top level's without the hidden
    instance), each child box the binary node's own, triangles as v0, e1,
    e2 and their ids; the stack bound covers the deepest walk."""
    pw = instanced_world(n=6, mirrored=True, hidden=4)
    t, _, _ = PT.build_tlas(pw.meshes, pw.instances)
    w = PT.build_walk(t)
    nodes = np.asarray(w.nodes)
    top = _skip_link_leaves(t.top_left, t.top_count, t.top_escape, 0)
    shown = [p for p in top if t.inst_root[t.top_inst[p]] >= 0]
    assert _wide_leaves(nodes, 0) == [-2 - p for p in shown]
    assert len(shown) == len(top) - 1
    for inst in range(t.num_instances):
        root = int(t.inst_root[inst])
        assert (root < 0) == (int(w.inst_root[inst]) < 0)
        if root < 0:
            continue
        want = [-2 - (s * 4 + int(t.blas_count[n]) - 1)
                for n, s in _blas_leaf_nodes(t, root)]
        assert _wide_leaves(nodes, int(w.inst_root[inst])) == want
    boxes = np.concatenate([np.concatenate([t.top_min, t.top_max], 1),
                            np.concatenate([t.blas_min, t.blas_max], 1)])
    held = nodes[..., [0, 1, 2, 4, 5, 6]].reshape(-1, 6)
    code = nodes[..., 3].copy().view(np.int32).reshape(-1)
    assert (held[code != -1][:, None] == boxes[None]).all(-1).any(1).all()
    tv = np.asarray(t.blas_tris)
    np.testing.assert_array_equal(w.tris[:, 0:3], tv[:, 0])
    np.testing.assert_array_equal(w.tris[:, 4:7], tv[:, 1] - tv[:, 0])
    np.testing.assert_array_equal(w.tris[:, 8:11], tv[:, 2] - tv[:, 0])
    np.testing.assert_array_equal(w.tris[:, 3].copy().view(np.int32),
                                  t.blas_tri_id)
    blas = {}

    def enter(code):
        r = int(w.inst_root[t.top_inst[-2 - code]])
        if r not in blas:
            blas[r] = _deepest(nodes, r) if r >= 0 else 0
        return blas[r]

    assert w.stack_depth >= _deepest(nodes, 0, enter)


def _blas_leaf_nodes(t, root):
    out, cur = [], int(root)
    while cur >= 0:
        if t.blas_count[cur] > 0:
            out.append((cur, int(t.blas_left[cur])))
            cur = int(t.blas_escape[cur])
        else:
            cur = int(t.blas_left[cur])
    return out


def _deepest(nodes, node, enter=None):
    """The most stack entries a walk from wide node `node` holds: all its
    children pushed, then each walked in turn above the siblings still
    on the stack; enter(code) -> the extra entries of the BLAS behind a
    top-level leaf."""
    codes = [int(c) for c in nodes[node, :, 3].copy().view(np.int32)
             if c != -1]
    most = len(codes)
    for i, c in enumerate(codes):
        below = len(codes) - 1 - i
        if c >= 0:
            most = max(most, below + _deepest(nodes, c, enter))
        elif enter is not None:
            most = max(most, below + enter(c))
    return most


def _np_hits(t, inst, o, d, lo, hi, t_max):
    """(hit, t) [N, hi - lo] of slots lo..hi of `inst`'s BLAS, in numpy
    float32 with the plain version's expressions in its order."""
    r = np.asarray(t.inst_inv)[inst]
    oo = np.stack([r[3 * i] * o[:, 0] + r[3 * i + 1] * o[:, 1]
                   + r[3 * i + 2] * o[:, 2] + r[9 + i] for i in range(3)],
                  -1)[:, None]
    dd = np.stack([r[3 * i] * d[:, 0] + r[3 * i + 1] * d[:, 1]
                   + r[3 * i + 2] * d[:, 2] for i in range(3)], -1)[:, None]
    v = np.asarray(t.blas_tris)[lo:hi][None]
    v0, e1, e2 = v[..., 0, :], v[..., 1, :] - v[..., 0, :], \
        v[..., 2, :] - v[..., 0, :]

    def cross(a, b):
        return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)

    def dot(a, b):
        p = a * b
        return p[..., 0] + p[..., 1] + p[..., 2]

    tiny = np.float32(1e-12)
    p = cross(dd, e2)
    det = dot(e1, p)
    inv_det = np.float32(1) / np.where(np.abs(det) < tiny, tiny, det)
    tv = oo - v0
    u = dot(tv, p) * inv_det
    q = cross(tv, e1)
    vv = dot(dd, q) * inv_det
    tt = dot(e2, q) * inv_det
    hit = ((np.abs(det) > tiny) & (u >= 0) & (vv >= 0) & (u + vv <= 1)
           & (tt > 0) & (tt < np.float32(t_max)))
    return hit, tt


def _brute_least_key(world, t, groups, o, d, t_max):
    """Per ray the least (t, top-level leaf position, BLAS slot) over
    every triangle hit of every visible instance: (tri, inst, lanes
    where two hits or more share the least t)."""
    starts = np.cumsum([0] + [c for _, c in groups.values()])
    slot0 = {k: int(s) for k, s in zip(groups, starts)}
    pos = np.empty(t.num_instances, np.int64)
    pos[np.asarray(t.top_inst)] = np.arange(t.num_instances)
    n = len(o)
    best_t = np.full(n, np.inf, np.float32)
    best_key = np.full(n, np.iinfo(np.int64).max)
    tri = np.full(n, -1, np.int32)
    inst_out = np.full(n, -1, np.int32)
    n_least = np.zeros(n, np.int64)
    for i, inst in enumerate(world.instances):
        if not inst.visible:
            continue
        k = tuple((g.mesh, g.material, g.sampled) for g in inst.geometries)
        lo, cnt = slot0[k], groups[k][1]
        hit, tt = _np_hits(t, i, o, d, lo, lo + cnt, t_max)
        tt = np.where(hit, tt, np.float32(np.inf))
        s = tt.argmin(1)  # the first slot of least t
        ts = tt[np.arange(n), s]
        key = pos[i] << 32 | (lo + s)
        n_least = np.where(ts < best_t, 0, n_least) + np.where(
            np.isfinite(ts) & (ts <= best_t), (tt == ts[:, None]).sum(1), 0)
        take = (ts < best_t) | ((ts == best_t) & (key < best_key))
        take &= np.isfinite(ts)
        best_t = np.where(take, ts, best_t)
        best_key = np.where(take, key, best_key)
        tri = np.where(take, np.asarray(t.blas_tri_id)[lo + s], tri)
        inst_out = np.where(take, i, inst_out)
    return tri, inst_out, n_least > 1


def test_equal_t_ties_resolve_as_the_reference_does():
    """On procedural.tie_scene (instances under one transform, repeated
    triangles): a numpy brute force of the least (t, top-level leaf
    position, BLAS slot) over every hit equals the plain walk and the
    reference's closest_hit_tlas in tri and inst, on lanes that tie."""
    from moonshine_tpu_torch.scene import procedural

    world, o, d = procedural.tie_scene(2048, seed=2)
    t, _, groups = PT.build_tlas(world.meshes, world.instances)
    tri, inst, tied = _brute_least_key(world, t, groups, o, d, INF_T)
    assert tied.sum() > 200 and (inst[tied] >= 0).all()
    got = PT.closest_hit_tlas_plain(PT.device_tlas(t, "cpu"),
                                    torch.from_numpy(o),
                                    torch.from_numpy(d), INF_T)
    jmesh = [JTy.Mesh(positions=m.positions, indices=m.indices)
             for m in world.meshes]
    jinst = [JTy.Instance(transform=i.transform, visible=i.visible,
                          geometries=[JTy.Geometry(g.mesh, g.material,
                                                   g.sampled)
                                      for g in i.geometries])
             for i in world.instances]
    jt, _, _ = JT.build_tlas(jmesh, jinst)
    want = JT.closest_hit_tlas(jt, o, d, INF_T)
    for name, a in (("port", got), ("reference", want)):
        np.testing.assert_array_equal(np.asarray(a.tri)[tied], tri[tied],
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(a.inst)[tied],
                                      inst[tied], err_msg=name)
        np.testing.assert_array_equal(np.asarray(a.tri), tri, err_msg=name)
        np.testing.assert_array_equal(np.asarray(a.inst), inst,
                                      err_msg=name)


def _tri_test(v0, e1, e2, o, d, bound):
    """visit.cuh tri_closest in float32 numpy scalars: (hit, t, u, v)."""
    f, tiny = np.float32, np.float32(1e-12)
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv_det = f(1) / (tiny if abs(det) < tiny else det)
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx, qy, qz = ty * e1[2] - tz * e1[1], tz * e1[0] - tx * e1[2], \
        tx * e1[1] - ty * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    hit = (abs(det) > tiny and u >= 0 and v >= 0 and u + v <= 1 and t > 0
           and t < bound)
    return hit, t, u, v


def walk_model(t, o, d, t_max, active, any_hit):
    """csrc/tlas.cu's walk of one ray at a time in float32 numpy, over the
    records (t.walk): near child first (the nearest hit child on top, the
    others in key order; any hit in key order), entries dropped at pop
    when past the best t, an instance entered and its BLAS root visited
    in one step, equal-t hits taken for a smaller key. Returns the plain
    version's outputs (TlasHit fields or the occlusion) and the most
    stack entries any ray held."""
    w = t.walk
    nodes = np.asarray(w.nodes)
    codes = nodes[..., 3].copy().view(np.int32)
    tris = np.asarray(w.tris)
    tids = tris[:, 3].copy().view(np.int32)
    w_root, top_inst = np.asarray(w.inst_root), np.asarray(t.top_inst)
    inv_m = np.asarray(t.inst_inv)
    inv_all = traverse._safe_inv(torch.from_numpy(d)).numpy()
    n, inf = len(o), np.float32(np.inf)
    res = (np.asarray(t_max, np.float32).copy(), np.full(n, -1, np.int32),
           np.zeros(n, np.float32), np.zeros(n, np.float32),
           np.full(n, -1, np.int32))
    occ = np.zeros(n, bool)
    most = 0
    for i in range(n):
        t_lane = np.float32(t_max[i])
        if (active is not None and not active[i]) or not t_lane > 0:
            continue
        t_far, best, hit = t_lane, (-1, -1), (-1, np.float32(0),
                                                np.float32(0), -1)
        stack, base, cur = [(0, -inf)], n + 10**9, (0, 0)
        ray = (o[i], inv_all[i])
        while stack:
            most = max(most, len(stack))
            while not any_hit and stack and stack[-1][1] > t_far:
                stack.pop()
            if not stack:
                break
            e = len(stack) - 1
            code, tn_e = stack.pop()
            obj = e >= base
            if not obj:
                base = n + 10**9
            if code < 0 and obj:  # a BLAS leaf
                x = -2 - code
                s0, cand = x >> 2, None
                for j in range((x & 3) + 1):
                    s = min(max(s0 + j, 0), len(tris) - 1)
                    r = tris[s]
                    if any_hit:
                        if _tri_test(r[0:3], r[4:7], r[8:11], oo, dd,
                                     t_lane)[0]:
                            occ[i], stack = True, []
                            break
                        continue
                    before = cur[0] < best[0] or (cur[0] == best[0]
                                                  and s < best[1])
                    bound = np.nextafter(t_far, inf) if before else t_far
                    h, tt, u, v = _tri_test(r[0:3], r[4:7], r[8:11], oo,
                                            dd, bound)
                    if h and (cand is None or tt < cand[0]):
                        cand = (tt, s, u, v)
                if cand is not None:
                    t_far, best = cand[0], (cur[0], cand[1])
                    hit = (tids[cand[1]], cand[2], cand[3], cur[1])
                continue
            if code < 0:  # enter the instance, then visit its root
                p = min(max(-2 - code, 0), len(top_inst) - 1)
                code = int(w_root[top_inst[p]])
                if code < 0:
                    continue
                r = inv_m[top_inst[p]]
                oi, di = o[i], d[i]
                oo = np.array([r[3 * c] * oi[0] + r[3 * c + 1] * oi[1]
                               + r[3 * c + 2] * oi[2] + r[9 + c]
                               for c in range(3)], np.float32)
                dd = np.array([r[3 * c] * di[0] + r[3 * c + 1] * di[1]
                               + r[3 * c + 2] * di[2] for c in range(3)],
                              np.float32)
                ray = (oo, traverse._safe_inv(torch.from_numpy(dd)).numpy())
                cur, base, obj = (p, int(top_inst[p])), len(stack), True
            ro, ri = ray if obj else (o[i], inv_all[i])
            if not obj:
                ray = (o[i], inv_all[i])
            rec, c = nodes[code], codes[code]
            with np.errstate(invalid="ignore", over="ignore"):
                t0 = (rec[:, 0:3] - ro) * ri
                t1 = (rec[:, 4:7] - ro) * ri
                tn = np.minimum(t0, t1).max(1)
                tf = np.maximum(t0, t1).min(1)
                nan = np.isnan(t0).any(1) | np.isnan(t1).any(1)
                prune = t_lane if any_hit else t_far
                ok = (c != -1) & ~nan & (tn <= tf) & (tf >= 0) & (tn <= prune)
            js = list(np.nonzero(ok)[0])
            if js and not any_hit:  # the nearest on top
                near = min(js, key=lambda j: (tn[j], j))
                js = [j for j in js if j != near] + [near]
                js = sorted(js[:-1], reverse=True) + [near]
            else:
                js = sorted(js, reverse=True)
            stack += [(int(c[j]), tn[j]) for j in js]
        if not any_hit:
            res[0][i] = t_far
            res[1][i], res[2][i], res[3][i], res[4][i] = hit
    return (occ if any_hit else res), most


def _grid_case(n, seed=5):
    """tests/test_torch_kernels_cuda.py's _tlas_case on the CPU."""
    from moonshine_tpu_torch.scene import procedural

    world, _ = procedural.instanced_scene(grid=(5, 4), subdivisions=2,
                                          seed=seed)
    world.set_visibility(7, False)
    t, _, _ = PT.build_tlas(world.meshes, world.instances)
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3) * np.float32([16, 14, 6])
         - np.float32([8, 7, 1])).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (PT.device_tlas(t, "cpu"), o, d, rs.rand(n) > 0.2,
            (rs.rand(n) * 12).astype(np.float32))


@pytest.mark.parametrize("scene", ["grid", "ties"])
def test_kernel_walk_model_matches_plain(scene):
    """The CPU model of the argument: csrc/tlas.cu's walk over the
    records, transcribed (walk_model), equals the plain walk bit for bit
    (t, tri, u, v, inst, occlusion) with unbounded and per-lane t_max,
    dead lanes included, on the instanced grid and on exact equal-t
    ties; its stack never holds more than the records' bound."""
    from moonshine_tpu_torch.scene import procedural

    if scene == "ties":
        world, o, d = procedural.tie_scene(1024, seed=3)
        t = PT.device_tlas(PT.build_tlas(world.meshes, world.instances)[0],
                           "cpu")
        active, t_lane = None, np.full(len(o), 14.0, np.float32)
    else:
        t, o, d, active, t_lane = _grid_case(1024)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    at = None if active is None else torch.from_numpy(active)
    for tm in (np.full(len(o), INF_T, np.float32), t_lane):
        want = PT.closest_hit_tlas_plain(t, ot, dt, torch.from_numpy(tm),
                                         active_in=at)
        got, most = walk_model(t, o, d, tm, active, False)
        assert int(want.is_hit.sum()) > 100
        for g, x, name in zip(got, want, want._fields):
            np.testing.assert_array_equal(g, x.numpy(), err_msg=name)
        occ, most_any = walk_model(t, o, d, tm, active, True)
        np.testing.assert_array_equal(occ, PT.any_hit_tlas_plain(
            t, ot, dt, torch.from_numpy(tm), active_in=at).numpy())
        assert max(most, most_any) <= t.walk.stack_depth
