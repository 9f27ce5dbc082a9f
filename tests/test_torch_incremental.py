"""The port's staged World.build against the reference's
(tests/test_incremental.py, whose cases each test here mirrors on the
port, the instancing cap's two among them):
transform and visibility edits refit instead of rebuilding topology,
material and background edits swap only their stage, and every edit
keeps array shapes. Added: the host refits (lbvh.refit_host and
wide.refit_wide) equal the reference's bit for bit on the same topology
and vertices, the port's edited scene equals the JAX World's edited
scene array for array, and that scene, flattened and loaded through
scene_from_arrays, traverses to the same hits."""

import numpy as np
import pytest
import torch

from moonshine_tpu.accel import lbvh as JL
from moonshine_tpu.accel import wide as JW
from moonshine_tpu.scene import types as JT
from moonshine_tpu.scene.world import World as JWorld
from moonshine_tpu_torch.accel import lbvh as PL
from moonshine_tpu_torch.accel import packet, traverse
from moonshine_tpu_torch.accel import wide as PW
from moonshine_tpu_torch.scene import types as PT
from moonshine_tpu_torch.scene.world import World, scene_from_arrays

from fixtures import icosphere
from test_torch_scene import ENV_KEYS, ENV_TOL, jax_scene_arrays, \
    _scene_tensors

INF_T = 1.0e12


def port_mesh(m) -> PT.Mesh:
    return PT.Mesh(positions=m.positions, indices=m.indices,
                   normals=m.normals, texcoords=m.texcoords,
                   indexed_attributes=m.indexed_attributes)


def two_sphere_world(T=PT, cls=World, mesh=port_mesh):
    w = cls()
    sphere = w.add_mesh(mesh(icosphere(2, with_normals=False)))
    mat = w.add_material(T.MaterialInfo(variant=T.Lambert(color=(1, 1, 1))))
    a = w.add_instance(T.Instance(transform=T.translate(-2, 0, 0),
                                  geometries=[T.Geometry(sphere, mat)]))
    b = w.add_instance(T.Instance(transform=T.translate(2, 0, 0),
                                  geometries=[T.Geometry(sphere, mat)]))
    w.set_background(None)
    return w, a, b


def hit_tris(scene, origins):
    """Closest-hit tri ids and t for downward rays (the per-lane walk of
    the binary tree, as the reference's test uses)."""
    o = torch.tensor(np.asarray(origins, np.float32))
    d = torch.tensor(np.float32([0, 0, -1])).repeat(len(o), 1)
    hit = traverse.closest_hit(scene.bvh, scene.tri_verts_sorted, o, d,
                               INF_T)
    return hit.tri.numpy(), hit.t.numpy()


def test_clean_build_returns_cached_scene():
    w, _, _ = two_sphere_world()
    s1 = w.build("cpu")
    assert w.build("cpu") is s1


def test_transform_edit_refits_without_topology_rebuild():
    w, a, b = two_sphere_world()
    s1 = w.build("cpu")
    w.set_transform(b, PT.translate(2, 0, 5))
    s2 = w.build("cpu")
    assert s2.bvh.tri_order is s1.bvh.tri_order
    assert s2.env is s1.env
    assert s2.materials.packed is s1.materials.packed
    assert s2.mat_atlas is s1.mat_atlas
    assert s2.wide.nodes.shape == s1.wide.nodes.shape
    assert s2.tri_shade.shape == s1.tri_shade.shape
    assert not torch.allclose(s2.wide.nodes, s1.wide.nodes)


def test_refit_matches_full_rebuild_hits():
    w, a, b = two_sphere_world()
    w.build("cpu")
    w.set_transform(b, PT.translate(2, 1, 0))
    refit_scene = w.build("cpu")
    fresh, _, _ = two_sphere_world()
    fresh.set_transform(1, PT.translate(2, 1, 0))
    full_scene = fresh.build("cpu")
    origins = [(-2, 0, 5), (2, 1, 5), (2, 0, 5), (0, 0, 5)]
    tri_r, t_r = hit_tris(refit_scene, origins)
    tri_f, t_f = hit_tris(full_scene, origins)
    np.testing.assert_allclose(t_r, t_f, rtol=1e-5)
    assert (tri_r >= 0).tolist() == (tri_f >= 0).tolist()


def test_visibility_toggle_is_shape_stable_refit():
    w, a, b = two_sphere_world()
    s1 = w.build("cpu")
    tri, _ = hit_tris(s1, [(2, 0, 5)])
    assert tri[0] >= 0
    w.set_visibility(b, False)
    s2 = w.build("cpu")
    assert s2.tri_shade.shape == s1.tri_shade.shape
    assert s2.bvh.tri_order is s1.bvh.tri_order
    tri, _ = hit_tris(s2, [(2, 0, 5)])
    assert tri[0] < 0
    w.set_visibility(b, True)
    s3 = w.build("cpu")
    tri, _ = hit_tris(s3, [(2, 0, 5)])
    assert tri[0] >= 0
    torch.testing.assert_close(s3.wide.nodes, s1.wide.nodes, rtol=0, atol=0)


def test_packet_kernel_agrees_after_refit():
    """The packet walk (its plain version here; the CUDA kernel on refit
    rows is tests/test_torch_kernels_cuda.py's) equals the per-lane walk
    of the refit binary tree within 1e-5 relative."""
    w, a, b = two_sphere_world()
    w.build("cpu")
    w.set_transform(b, PT.translate(2, 0, 3))
    scene = w.build("cpu")
    o = torch.tensor(np.float32([[-2, 0, 5], [2, 0, 5], [0, 0, 5]]))
    d = torch.tensor(np.float32([0, 0, -1])).repeat(3, 1)
    ref = traverse.closest_hit(scene.bvh, scene.tri_verts_sorted, o, d,
                               INF_T)
    pk = packet.closest_hit_packet(scene.wide, o, d, INF_T)
    np.testing.assert_allclose(pk.t.numpy(), ref.t.numpy(), rtol=1e-5)


def test_material_edit_rebuilds_only_materials():
    w, a, b = two_sphere_world()
    s1 = w.build("cpu")
    w.update_material(0, PT.MaterialInfo(variant=PT.Lambert(color=(1, 0, 0))))
    s2 = w.build("cpu")
    assert s2.bvh is s1.bvh
    assert s2.wide is s1.wide
    assert s2.env is s1.env
    assert s2.materials.packed is not s1.materials.packed
    assert torch.equal(s2.tri_shade[:, :32], s1.tri_shade[:, :32])
    ids = s1.tri_shade[:, 24].to(torch.int64)
    assert torch.equal(s2.tri_shade[:, 32:], s2.materials.packed[ids])


def test_background_edit_rebuilds_only_env():
    w, a, b = two_sphere_world()
    s1 = w.build("cpu")
    sky = np.zeros((4, 8, 3), np.float32)
    sky[:2] = 2.0
    w.set_background(sky)
    s2 = w.build("cpu")
    assert s2.bvh is s1.bvh
    assert s2.wide is s1.wide
    assert s2.materials.packed is s1.materials.packed
    assert s2.env is not s1.env


def test_topology_edit_triggers_full_rebuild():
    w, a, b = two_sphere_world()
    s1 = w.build("cpu")
    sphere2 = w.add_mesh(port_mesh(icosphere(1, with_normals=False)))
    w.add_instance(PT.Instance(transform=PT.translate(0, 0, 8),
                               geometries=[PT.Geometry(sphere2, 0)]))
    s2 = w.build("cpu")
    assert s2.num_tris > s1.num_tris
    tri, _ = hit_tris(s2, [(0, 0, 12)])
    assert tri[0] >= 0


def emitter_world():
    w = World()
    quad = w.add_mesh(PT.Mesh(
        positions=np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                              [-1, 1, 0]]),
        indices=np.uint32([[0, 1, 2], [0, 2, 3]])))
    mat = w.add_material(PT.MaterialInfo(variant=PT.Lambert(color=(0, 0, 0)),
                                         emissive=(5.0, 5.0, 5.0)))
    inst = w.add_instance(PT.Instance(
        transform=PT.translate(0, 0, 2),
        geometries=[PT.Geometry(quad, mat, sampled=True)]))
    return w, inst


def test_emitter_refit_tracks_transform_scale():
    """Emissive area follows the instance's scale; hiding the only
    emitter drops count to 0 with unchanged shapes."""
    w, inst = emitter_world()
    s1 = w.build("cpu")
    w1 = float(s1.emitters.weight_sum)
    w.set_transform(inst, PT.scale_uniform(2.0, (0, 0, 2)))
    s2 = w.build("cpu")
    assert float(s2.emitters.weight_sum) == pytest.approx(4 * w1, rel=1e-5)
    w.set_visibility(inst, False)
    s3 = w.build("cpu")
    assert int(s3.emitters.count) == 0
    assert s3.emitters.select.shape == s2.emitters.select.shape


def test_multiple_backgrounds_switch_and_cache():
    w, a, b = two_sphere_world()
    h_dark = w.add_background(np.full((4, 8, 3), 0.1, np.float32))
    h_bright = w.add_background(np.full((4, 8, 3), 5.0, np.float32))
    w.use_background(h_dark)
    s1 = w.build("cpu")
    env_dark = s1.env
    w.use_background(h_bright)
    s2 = w.build("cpu")
    assert s2.env is not env_dark
    assert float(s2.env.integral) > float(env_dark.integral)
    assert s2.bvh is s1.bvh
    w.use_background(h_dark)
    s3 = w.build("cpu")
    assert s3.env is env_dark


# --- against the reference ---

def _edit(w, T, b):
    """The edits both packages replay: a move, a hide and a show."""
    w.set_transform(b, T.translate(2.5, 0.5, 1.0))
    w.set_visibility(0, False)
    w.set_visibility(0, True)
    w.set_visibility(b, False)
    w.set_visibility(b, True)
    w.set_transform(0, T.scale_uniform(1.5, (-2, 0, -1)))


@pytest.mark.parametrize("builder", ["karras", "sah"])
def test_host_refits_match_reference(builder):
    """lbvh.refit_host and wide.refit_wide_rows give the reference's
    lbvh.refit_host / wide.refit_wide rows bit for bit, on one binary
    tree and moved vertices (and refit_wide's topology is the build's)."""
    rs = np.random.RandomState(3)
    tris = (rs.rand(300, 3, 3) * 4).astype(np.float32)
    bvh = (PL.build_sah(tris) if builder == "sah" else PL.build(tris))
    moved = tris + (rs.rand(300, 1, 3) * 0.5).astype(np.float32)
    args = (bvh.left, bvh.count, bvh.escape, bvh.tri_order, moved)
    p_min, p_max = PL.refit_host(*args)
    j_min, j_max = JL.refit_host(*args)
    np.testing.assert_array_equal(p_min, j_min)
    np.testing.assert_array_equal(p_max, j_max)
    rows = PW.build_wide_rows(tris, binary=bvh, width=16, leaf_cap=12)
    jb = JL.BVH(aabb_min=bvh.aabb_min, aabb_max=bvh.aabb_max, left=bvh.left,
                count=bvh.count, escape=bvh.escape, tri_order=bvh.tri_order,
                num_nodes=bvh.num_nodes, num_tris=bvh.num_tris,
                parent=bvh.parent)
    _, jtopo = JW.build_wide(tris, binary=jb, with_topology=True, width=16,
                             leaf_cap=12)
    for f in ("int_ids", "ptr", "node_axis", "orig", "in_range",
              "treelet_roots"):
        np.testing.assert_array_equal(getattr(rows.topo, f),
                                      getattr(jtopo, f), err_msg=f)
    got = PW.refit_wide_rows(rows.topo, p_min, p_max, moved)
    want = JW.refit_wide(jtopo, j_min, j_max, moved)
    for f, g in (("nodes", got.nodes), ("leaves", got.leaves),
                 ("bounds", got.bounds), ("t_lo", got.t_lo),
                 ("t_hi", got.t_hi)):
        np.testing.assert_array_equal(g, np.asarray(getattr(want, f)),
                                      err_msg=f)
    wb = PW.refit_wide(rows.topo, p_min, p_max, moved, device="cpu")
    assert torch.equal(wb.nodes, torch.from_numpy(got.nodes))
    assert (wb.top_rows, wb.max_depth) == (
        PW.top_rows(got.nodes, 16), rows.n_levels)


def _jax_mesh(m):
    return m


@pytest.mark.parametrize("builder", ["karras", "sah"])
def test_edited_scene_matches_reference(builder):
    """Both packages' Worlds replay the same edits (moves, hides, then a
    material edit): after the refit and after the material-only rebuild
    the port's scene equals the JAX World's, array for array (the env
    texels to 1e-6 relative), and the JAX scene, flattened and loaded
    through scene_from_arrays, traverses to the port's hits."""
    pw, _, pb = two_sphere_world()
    jw, _, jb = two_sphere_world(JT, JWorld, _jax_mesh)
    ps, js0 = pw.build("cpu", builder=builder), jw.build(builder=builder)
    _edit(pw, PT, pb)
    _edit(jw, JT, jb)
    red = dict(variant=None, emissive=(0.5, 0.0, 0.0))
    for stage in ("refit", "material"):
        if stage == "material":
            pw.update_material(0, PT.MaterialInfo(
                variant=PT.Lambert(color=(1, 0, 0)), emissive=red["emissive"]))
            jw.update_material(0, JT.MaterialInfo(
                variant=JT.Lambert(color=(1, 0, 0)), emissive=red["emissive"]))
        ps, js = pw.build("cpu", builder=builder), jw.build(builder=builder)
        if stage == "refit":
            assert js.bvh.tri_order is js0.bvh.tri_order  # a refit there too
        want, want_s = jax_scene_arrays(js)
        got = _scene_tensors(ps)
        for key, w in want.items():
            g = got[key]
            g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
            if key in ENV_KEYS:
                np.testing.assert_allclose(g, w, **ENV_TOL, err_msg=key)
            else:
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg=f"{stage} {key}")
        n = len(ps.bvh.left)
        for f in ("aabb_min", "aabb_max"):
            np.testing.assert_array_equal(
                getattr(ps.bvh, f).numpy(),
                np.asarray(getattr(js.bvh, f))[:n], err_msg=f)
        np.testing.assert_array_equal(ps.tri_verts_sorted.numpy(),
                                      np.asarray(js.tri_verts_sorted))
        assert ps.emitters.count == want_s["emitters.count"]
        loaded = scene_from_arrays(want, want_s, "cpu")
        rs = np.random.RandomState(5)
        o = torch.tensor((rs.rand(512, 3) * 8 - 4).astype(np.float32))
        d = torch.tensor(rs.randn(512, 3).astype(np.float32))
        d = d / d.norm(dim=1, keepdim=True)
        h_loaded = packet.closest_hit_packet(loaded.wide, o, d, INF_T)
        h_port = packet.closest_hit_packet(ps.wide, o, d, INF_T)
        for a, b in zip(h_loaded, h_port):
            assert torch.equal(a, b)
        assert int((h_port.tri >= 0).sum()) > 20


def test_empty_world_and_device_switch():
    """An edit on a world with no triangles builds; a build for another
    device (here the same CPU given as a torch.device) reuses nothing but
    gives the same arrays."""
    w = World()
    w.set_background(None)
    s1 = w.build("cpu")
    w.add_material(PT.MaterialInfo(variant=PT.Lambert(color=(1, 1, 1))))
    s2 = w.build(torch.device("cpu"))
    assert s2.num_tris == 1 and torch.equal(s2.wide.nodes, s1.wide.nodes)


class TestInstancingCap:
    """tests/test_incremental.py's TestInstancingCap on the port."""

    def test_flatten_cap_switches_to_tlas(self, monkeypatch):
        """Past the flatten cap the build switches to two-level instancing
        (shared BLAS per unique geometry + TLAS over instance boxes), with
        the reference's warning, instead of count x tris rows."""
        monkeypatch.setenv("MSN_MAX_FLAT_TRIS", "1000")
        w = World()
        sphere = w.add_mesh(port_mesh(icosphere(2, with_normals=False)))
        mat = w.add_material(PT.MaterialInfo(variant=PT.Lambert(
            color=(1, 1, 1))))
        n_tris = len(icosphere(2, with_normals=False).indices)
        n_inst = 1000 // n_tris + 2
        for i in range(n_inst):
            w.add_instance(PT.Instance(transform=PT.translate(i * 3.0, 0, 0),
                                       geometries=[PT.Geometry(sphere, mat)]))
        w.set_background(None)
        with pytest.warns(UserWarning, match="two-level instancing"):
            scene = w.build("cpu")
        assert scene.tlas is not None and scene.wide is None
        assert scene.tri_shade.shape[0] == n_tris
        assert scene.tlas.num_instances == n_inst

    def test_cap_override(self, monkeypatch):
        monkeypatch.setenv("MSN_MAX_FLAT_TRIS", "100000000")
        w, a, b = two_sphere_world()
        scene = w.build("cpu")
        assert scene is not None and scene.tlas is None
