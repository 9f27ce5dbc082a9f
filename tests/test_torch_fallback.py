"""The per-lane fallback walk (accel/traverse.py) and the dispatch's fourth
mode against moonshine_tpu's `traverse` and its "jnp" mode.

Tolerances: the walk is the reference's, lane for lane, in torch ops;
XLA's CPU backend contracts the Moller-Trumbore products into fused
multiply-adds, which torch does not, so t agrees to 2e-6 relative (1.2e-6
measured on 1 of 1200 lanes), u and v to 1e-4 (tests/test_torch_traverse.py's
bar; 1.2e-5 measured), tri everywhere but at equal-t ties, and occlusion
exactly. The render holds tests/test_torch_render.py's image bar: >= 99%
of pixels within 1e-3 (abs + rel), means within 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.accel import lbvh as JL
from moonshine_tpu.accel import packet as JPk
from moonshine_tpu.accel import traverse as JT
from moonshine_tpu.accel import wide as JW
from moonshine_tpu.integrator import path as JPath
from moonshine_tpu_torch.accel import lbvh as PL
from moonshine_tpu_torch.accel import packet as PPk
from moonshine_tpu_torch.accel import traverse as PT
from moonshine_tpu_torch.accel import wide as PW
from moonshine_tpu_torch.integrator import path as PPath
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.render.renderer import render_spp
from moonshine_tpu_torch.scene import procedural

from test_bvh import random_rays, random_tris
from test_torch_render import assert_image_close

CFG = dict(max_bounces=4, env_samples_per_bounce=1,
           mesh_samples_per_bounce=1)
N_RAYS = 1200


@pytest.fixture(scope="module")
def bridged():
    """One JAX-built binary BVH over 500 triangles, as the reference holds
    it and bridged into the port, with seeded rays."""
    tris = random_tris(500, seed=12)
    jb = JL.build(tris)
    pb = PL.device_bvh(PL.BVH(
        *(np.asarray(getattr(jb, f)) for f in (
            "aabb_min", "aabb_max", "left", "count", "escape",
            "tri_order")), num_nodes=jb.num_nodes, num_tris=jb.num_tris,
        parent=np.asarray(jb.parent)), "cpu")
    order = np.asarray(jb.tri_order)
    o, d = (np.array(x) for x in random_rays(N_RAYS, seed=13))
    rs = np.random.RandomState(14)
    return dict(tris=tris, jb=jb, pb=pb, o=o, d=d,
                jsorted=jnp.asarray(tris[order]),
                psorted=torch.from_numpy(tris[order]),
                active=rs.rand(N_RAYS) > 0.2,
                t_max=(rs.rand(N_RAYS) * 12.0).astype(np.float32))


def _assert_hits_close(got, want):
    g_tri, w_tri = got.tri.numpy(), np.asarray(want.tri)
    np.testing.assert_array_equal(g_tri >= 0, w_tri >= 0)
    g_t, w_t = got.t.numpy(), np.asarray(want.t)
    np.testing.assert_allclose(g_t, w_t, rtol=2e-6)
    same = g_tri == w_tri
    assert (same | (g_t == w_t)).all()  # a differing tri only on equal t
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(want.u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(got.v.numpy()[same], np.asarray(want.v)[same],
                               atol=1e-4)
    assert (w_tri >= 0).sum() >= 50


def test_closest_hit_matches_reference(bridged):
    b = bridged
    act = b["active"]
    want = JT.closest_hit(b["jb"], b["jsorted"], jnp.asarray(b["o"]),
                          jnp.asarray(b["d"]), 1e12,
                          active_in=jnp.asarray(act))
    got = PT.closest_hit(b["pb"], b["psorted"], torch.from_numpy(b["o"]),
                         torch.from_numpy(b["d"]), 1e12,
                         active_in=torch.from_numpy(act))
    _assert_hits_close(got, want)
    assert (got.tri.numpy()[~act] == -1).all()
    assert (got.t.numpy()[~act] == np.float32(1e12)).all()


def test_any_hit_matches_reference(bridged):
    b = bridged
    want = np.asarray(JT.any_hit(
        b["jb"], b["jsorted"], jnp.asarray(b["o"]), jnp.asarray(b["d"]),
        jnp.asarray(b["t_max"]), active_in=jnp.asarray(b["active"])))
    got = PT.any_hit(b["pb"], b["psorted"], torch.from_numpy(b["o"]),
                     torch.from_numpy(b["d"]), torch.from_numpy(b["t_max"]),
                     active_in=torch.from_numpy(b["active"]))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() >= 20 and not want[~b["active"]].any()


def test_brute_force_matches_reference(bridged):
    """The oracle against the reference's, and the walk against the
    oracle."""
    b = bridged
    o, d = torch.from_numpy(b["o"]), torch.from_numpy(b["d"])
    want = JT.brute_force_closest(jnp.asarray(b["tris"]), jnp.asarray(b["o"]),
                                  jnp.asarray(b["d"]), 1e12)
    got = PT.brute_force_closest(torch.from_numpy(b["tris"]), o, d, 1e12)
    _assert_hits_close(got, want)
    walk = PT.closest_hit(b["pb"], b["psorted"], o, d, 1e12)
    assert torch.equal(walk.tri >= 0, got.tri >= 0)
    torch.testing.assert_close(walk.t, got.t, rtol=0, atol=0)


def test_call_counts(bridged):
    b = bridged
    o, d = torch.from_numpy(b["o"][:64]), torch.from_numpy(b["d"][:64])
    PT.reset_call_counts()
    PT.closest_hit(b["pb"], b["psorted"], o, d, 1e12)
    PT.any_hit(b["pb"], b["psorted"], o, d, 2.0)
    PT.any_hit(b["pb"], b["psorted"], o, d, 2.0)
    assert PT.CALLS == {"closest_hit": 1, "any_hit": 2}


def _limits(monkeypatch, budget, hbm_depth, depth):
    for mod in (JPk, PPk):
        monkeypatch.setattr(mod, "VMEM_SCENE_BUDGET_BYTES", budget)
        monkeypatch.setattr(mod, "HBM_STACK_DEPTH", hbm_depth)
        monkeypatch.setattr(mod, "STACK_DEPTH", depth)


@pytest.mark.parametrize("width,cap", [(16, 12), (8, 8)])
def test_hbm_mode_matches_reference(monkeypatch, width, cap):
    """_hbm_mode returns 'lanes' exactly where the reference returns 'jnp',
    and agrees on the other modes, over both residency limits, both stack
    limits and the treelet switch; a missing wide tree is 'lanes'."""
    tris = random_tris(4000, seed=2)  # 8/8: over 384 rows, K >= 2
    jw = JW.build_wide(tris, leaf_cap=cap, width=width)
    pw = PW.build_wide(tris, leaf_cap=cap, width=width, device="cpu")
    assert jw.max_stack == pw.max_stack
    seen = set()
    for treelets in (False, True):
        monkeypatch.setattr(JPath, "_USE_TREELETS", treelets)
        monkeypatch.setenv("MSN_TREELETS", "1" if treelets else "0")
        for budget in (10 * 1024 * 1024, 0):
            for hbm_depth in (256, pw.max_stack - 1):
                for depth in (512, pw.max_stack - 1):
                    _limits(monkeypatch, budget, hbm_depth, depth)
                    want = JPath._hbm_mode(jw)
                    got = PPath._hbm_mode(pw)
                    assert got == {"jnp": "lanes"}.get(want, want)
                    seen.add(got)
    assert JPath._hbm_mode(None) == "jnp" and PPath._hbm_mode(None) == "lanes"
    assert {"vmem", "hbm", "lanes"} <= seen
    assert ("treelet" in seen) == (width == 8)


def test_world_build_carries_the_binary_tree():
    """World.build fills DeviceScene.bvh and tri_verts_sorted as the
    reference's does (its node arrays padded to a power of two, which the
    port drops); scene_from_arrays carries them."""
    from moonshine_tpu.scene import procedural as JProc

    from test_torch_scene import jax_scene_arrays
    from moonshine_tpu_torch.scene.world import scene_from_arrays

    jw, _ = JProc.room_scene(grid=2, subdivisions=2)
    js = jw.build()
    pw, _ = procedural.room_scene(grid=2, subdivisions=2)
    ps = pw.build("cpu")
    n = ps.bvh.num_nodes
    for f in ("aabb_min", "aabb_max", "left", "count", "escape"):
        np.testing.assert_array_equal(getattr(ps.bvh, f).numpy(),
                                      np.asarray(getattr(js.bvh, f))[:n])
    np.testing.assert_array_equal(ps.bvh.tri_order.numpy(),
                                  np.asarray(js.bvh.tri_order))
    np.testing.assert_array_equal(ps.tri_verts_sorted.numpy(),
                                  np.asarray(js.tri_verts_sorted))
    arrays, statics = jax_scene_arrays(js)
    assert scene_from_arrays(arrays, statics, "cpu").bvh is None
    arrays.update({f"bvh.{f}": np.asarray(getattr(js.bvh, f)) for f in (
        "aabb_min", "aabb_max", "left", "count", "escape", "tri_order")})
    arrays["tri_verts_sorted"] = np.asarray(js.tri_verts_sorted)
    bridged = scene_from_arrays(arrays, statics, "cpu")
    np.testing.assert_array_equal(bridged.bvh.escape.numpy(),
                                  np.asarray(js.bvh.escape))
    assert bridged.bvh.parent is None
    assert torch.equal(bridged.tri_verts_sorted, ps.tri_verts_sorted)


@pytest.fixture
def fresh_traces():
    """The reference picks its dispatch mode at trace time: drop cached
    traces before and after a test that changes the limits."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_lanes_render_matches_reference(monkeypatch, fresh_traces):
    """The flagship, 32x32 x 1 spp, with both packages forced into the
    per-lane walk (HBM-class, stack limit 1): every closest and any hit
    goes through accel/traverse.py, none through the packet traversal, and
    the image agrees with the reference's "jnp"-mode render."""
    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator.path import PathConfig as JaxPathConfig
    from moonshine_tpu.render.camera import LensArrays as JaxLens
    from moonshine_tpu.render.renderer import render_spp as jax_render_spp

    _limits(monkeypatch, 0, 1, 512)
    js, jlens = _flagship_scene()
    assert JPath._hbm_mode(js.wide) == "jnp"
    want, want_rays = jax_render_spp(js, JaxLens.from_lens(jlens), 32, 32, 0,
                                     1, JaxPathConfig(**CFG))
    world, lens = procedural.flagship_scene()
    scene = world.build("cpu")
    assert PPath._hbm_mode(scene.wide) == "lanes"
    packet_calls = []
    for name in ("closest_hit_packet", "any_hit_packet"):
        fn = getattr(PPk, name)
        monkeypatch.setattr(PPk, name, lambda *a, _fn=fn, **k:
                            packet_calls.append(1) or _fn(*a, **k))
    PT.reset_call_counts()
    stats = {}
    got, rays = render_spp(scene, LensArrays.from_lens(lens, "cpu"), 32, 32,
                           0, 1, PathConfig(**CFG), stats=stats)
    assert stats["resort"] is False
    assert PT.CALLS == {"closest_hit": stats["segments"], "any_hit": 5}
    assert not packet_calls
    assert_image_close(got.numpy(), np.asarray(want))
    assert abs(int(rays) / float(want_rays) - 1.0) <= 1e-2
