"""Spatial-split (SBVH presplit) builds: the port's `presplit_refs`,
`build_sah(refs=...)`, clipped wide rows and `MSN_PRESPLIT` World builds
against moonshine_tpu's, exactly; and traversal of the presplit tree in
every dispatch mode against the default tree's.

The scene is the reference's own presplit test scene
(tests/test_packet.py `test_presplit_refs_match_default`): 300 small
triangles and three room-spanning walls. Duplicate references change
which leaves a ray visits, never what it hits: t and is_hit are equal,
tri only up to equal-t ties."""

import types

import numpy as np
import pytest
import torch

from moonshine_tpu.accel import lbvh as JL
from moonshine_tpu.accel import wide as JW
from moonshine_tpu.scene import procedural as JP
from moonshine_tpu_torch.accel import lbvh as PL
from moonshine_tpu_torch.accel import packet as PPk
from moonshine_tpu_torch.accel import traverse as PT
from moonshine_tpu_torch.accel import wide as PW
from moonshine_tpu_torch.integrator import path as PPath
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.render.renderer import render_spp
from moonshine_tpu_torch.scene import procedural as PP

from test_bvh import random_rays
from test_torch_render import assert_image_close
from test_torch_scene import ENV_KEYS, ENV_TOL, jax_scene_arrays

INF_T = 1e12


def wall_scene():
    rs = np.random.RandomState(23)
    c = rs.rand(300, 1, 3).astype(np.float32) * 10
    tris = c + (rs.rand(300, 3, 3).astype(np.float32) - 0.5) * 0.4
    walls = np.asarray([
        [[0, 0, 0], [10, 0, 0], [10, 10, 0]],
        [[0, 0, 0], [10, 10, 0], [0, 10, 0]],
        [[0, 0, 10], [10, 0, 10], [10, 10, 10]],
    ], np.float32)
    return np.concatenate([tris, walls])


@pytest.fixture(scope="module")
def scene():
    tris = wall_scene()
    refs = PL.presplit_refs(tris, max_refs_factor=1.5)
    bvh, cl, ch = PL.build_sah(tris, refs=refs)
    o, d = (torch.from_numpy(np.array(x)) for x in random_rays(512, seed=24))
    # rays from inside the box too, so the walls are hit from both sides
    rs = np.random.RandomState(25)
    o_in = torch.from_numpy(rs.uniform(0.5, 9.5, (512, 3)).astype(np.float32))
    d_in = torch.from_numpy(rs.randn(512, 3).astype(np.float32))
    d_in = d_in / torch.linalg.norm(d_in, dim=1, keepdim=True)
    return dict(tris=tris, refs=refs, bvh=bvh, clip=(cl, ch),
                o=torch.cat([o, o_in]), d=torch.cat([d, d_in]))


@pytest.mark.parametrize("factor", [1.1, 1.35, 1.5])
def test_presplit_refs_match_reference(factor):
    tris = wall_scene()
    want = JL.presplit_refs(tris, max_refs_factor=factor)
    got = PL.presplit_refs(tris, max_refs_factor=factor)
    assert len(got[0]) > len(tris)  # the walls split
    assert len(got[0]) <= int(len(tris) * factor)
    for g, w, name in zip(got, want, ("ref_tri", "ref_lo", "ref_hi")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_presplit_boxes_are_conservative(scene):
    """Every reference box lies inside its triangle's box, and the union
    of a triangle's reference boxes covers its corners."""
    tris = scene["tris"]
    ref_tri, lo, hi = scene["refs"]
    tmin, tmax = tris.min(axis=1), tris.max(axis=1)
    assert (lo >= np.nextafter(tmin[ref_tri], -np.inf)).all()
    assert (hi <= np.nextafter(tmax[ref_tri], np.inf)).all()
    for t in np.unique(ref_tri[len(tris):]):
        sel = ref_tri == t
        for corner in tris[t]:
            assert ((lo[sel] <= corner) & (corner <= hi[sel])).all(1).any()


def test_build_sah_refs_matches_reference(scene):
    tris, refs = scene["tris"], scene["refs"]
    want, wcl, wch = JL.build_sah(tris, as_numpy=True, refs=refs,
                                  pad_nodes_to_pow2=False)
    got, gcl, gch = PL.build_sah(tris, refs=refs)
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(gcl, wcl)
    np.testing.assert_array_equal(gch, wch)
    assert got.num_tris == len(refs[0]) > len(tris)
    # tri_order repeats the split triangles' ids
    assert len(np.unique(got.tri_order)) == len(tris)
    with pytest.raises(ValueError, match="presplit"):
        PL.build_sah(tris[:3], refs=tuple(r[:3] for r in refs))


@pytest.mark.parametrize("width,cap", [(8, 8), (16, 12), (24, 24)])
def test_clipped_wide_rows_match_reference(scene, width, cap):
    tris, refs = scene["tris"], scene["refs"]
    jb, jcl, jch = JL.build_sah(tris, as_numpy=True, refs=refs)
    want, topo = JW.build_wide(tris, binary=jb, clip_sorted=(jcl, jch),
                               width=width, leaf_cap=cap, with_topology=True)
    got = PW.build_wide_rows(tris, binary=scene["bvh"], width=width,
                             leaf_cap=cap, clip_sorted=scene["clip"])
    for name in ("nodes", "leaves", "bounds", "t_lo", "t_hi"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.t_roots, np.asarray(want.t_roots))
    assert got.n_levels == want.max_depth
    # the clipped boxes are tighter than the whole triangles' boxes
    plain = PW.build_wide_rows(tris, binary=scene["bvh"], width=width,
                               leaf_cap=cap)
    assert not np.array_equal(plain.nodes, got.nodes)


def _assert_same_hits(got, want):
    np.testing.assert_array_equal(got.tri.numpy() >= 0, want.tri.numpy() >= 0)
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())
    differ = got.tri != want.tri
    assert torch.equal(got.t[differ], want.t[differ])  # ties only
    assert int((want.tri >= 0).sum()) >= 150


def test_presplit_traversal_matches_default(scene):
    """Plain packet closest / any hit on the presplit 16/12 tree equal the
    default tree's, and so does the per-lane walk of the presplit binary
    tree over its R sorted references."""
    tris, o, d = scene["tris"], scene["o"], scene["d"]
    w1 = PW.build_wide(tris, binary=scene["bvh"], clip_sorted=scene["clip"],
                       width=16, leaf_cap=12, device="cpu")
    w0 = PW.build_wide(tris, width=16, leaf_cap=12, device="cpu")
    h0 = PPk.closest_hit_plain(w0, o, d, INF_T)
    _assert_same_hits(PPk.closest_hit_plain(w1, o, d, INF_T), h0)
    t_max = torch.full((o.shape[0],), 6.0)
    a0 = PPk.any_hit_plain(w0, o, d, t_max)
    assert torch.equal(PPk.any_hit_plain(w1, o, d, t_max), a0)
    bvh = PL.device_bvh(scene["bvh"], "cpu")
    tvs = torch.from_numpy(tris[scene["bvh"].tri_order])
    assert tvs.shape[0] == len(scene["refs"][0])
    _assert_same_hits(PT.closest_hit(bvh, tvs, o, d, INF_T), h0)
    assert torch.equal(PT.any_hit(bvh, tvs, o, d, t_max), a0)


def test_every_dispatch_mode_traverses_the_presplit_tree(scene, monkeypatch):
    """path._closest / _any_hit in modes vmem, hbm, treelet and lanes on
    the presplit 8/8 tree (small treelets) give the default tree's
    hits."""
    tris, o, d = scene["tris"], scene["o"], scene["d"]
    wide = PW.build_wide(tris, binary=scene["bvh"], clip_sorted=scene["clip"],
                         width=8, leaf_cap=8, device="cpu", max_rows=16)
    sc = types.SimpleNamespace(
        wide=wide, bvh=PL.device_bvh(scene["bvh"], "cpu"),
        tri_verts_sorted=torch.from_numpy(tris[scene["bvh"].tri_order]))
    w0 = PW.build_wide(tris, width=8, leaf_cap=8, device="cpu")
    active = torch.ones(o.shape[0], dtype=torch.bool)
    t_max = torch.full((o.shape[0],), 6.0)
    h0 = PPk.closest_hit_plain(w0, o, d, INF_T)
    a0 = PPk.any_hit_plain(w0, o, d, t_max)
    seen = []
    for budget, treelets, depth in ((None, "0", None), (0, "0", None),
                                    (0, "1", None), (0, "0", 1)):
        with monkeypatch.context() as m:
            if budget is not None:
                m.setattr(PPk, "VMEM_SCENE_BUDGET_BYTES", budget)
            if depth is not None:
                m.setattr(PPk, "HBM_STACK_DEPTH", depth)
            m.setenv("MSN_TREELETS", treelets)
            seen.append(PPath._hbm_mode(wide))
            _assert_same_hits(PPath._closest(sc, o, d, INF_T, active), h0)
            assert torch.equal(PPath._any_hit(sc, o, d, t_max, active), a0)
    assert seen == ["vmem", "hbm", "treelet", "lanes"]


def test_world_presplit_matches_reference(monkeypatch):
    """MSN_PRESPLIT=1.35 with builder="sah": the flattened arrays, the
    binary tree and the R sorted reference rows equal the JAX World's."""
    monkeypatch.setenv("MSN_PRESPLIT", "1.35")
    jw, _ = JP.room_scene(grid=2, subdivisions=2)
    pw, _ = PP.room_scene(grid=2, subdivisions=2)
    js = jw.build(builder="sah")
    want, want_s = jax_scene_arrays(js)
    got, got_s = pw.build_arrays(builder="sah")
    for key, w in want.items():
        g = got[key]
        if key.startswith("mat_atlas."):  # bf16 planes, rounded on the device
            g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
        if key in ENV_KEYS:
            np.testing.assert_allclose(g, w, **ENV_TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=key)
    for key in ("wide.max_depth", "wide.width", "wide.leaf_slots"):
        assert got_s[key] == want_s[key], key
    n_tris = len(got["tri_shade"])
    assert len(got["bvh.tri_order"]) > n_tris
    np.testing.assert_array_equal(got["bvh.tri_order"],
                                  np.asarray(js.bvh.tri_order))
    np.testing.assert_array_equal(got["tri_verts_sorted"],
                                  np.asarray(js.tri_verts_sorted))
    n = len(got["bvh.left"])
    for f in ("aabb_min", "aabb_max", "left", "count", "escape"):
        np.testing.assert_array_equal(got[f"bvh.{f}"],
                                      np.asarray(getattr(js.bvh, f))[:n],
                                      err_msg=f)
    # off by default, and on the Karras builder
    monkeypatch.setenv("MSN_PRESPLIT", "1.0")
    assert len(pw.build_arrays(builder="sah")[0]["bvh.tri_order"]) == n_tris
    monkeypatch.setenv("MSN_PRESPLIT", "1.35")
    assert len(pw.build_arrays(builder="karras")[0]["bvh.tri_order"]) \
        == n_tris


def test_presplit_render_matches_default(monkeypatch):
    """The small room rendered from the presplit build against the default
    SAH build (32x32, 1 spp)."""
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    world, lens = PP.room_scene(grid=2, subdivisions=2)
    lens = LensArrays.from_lens(lens, "cpu")
    want, _ = render_spp(world.build("cpu", builder="sah"), lens, 32, 32, 0,
                         1, cfg)
    monkeypatch.setenv("MSN_PRESPLIT", "1.35")
    # a fresh World: a built one returns its cached scene until edited
    world, _ = PP.room_scene(grid=2, subdivisions=2)
    scene = world.build("cpu", builder="sah")
    assert scene.tri_verts_sorted.shape[0] > scene.num_tris
    got, _ = render_spp(scene, lens, 32, 32, 0, 1, cfg)
    assert_image_close(got.numpy(), want.numpy())
