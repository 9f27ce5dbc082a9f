"""The port's World.build against moonshine_tpu's, leaf for leaf, and the
state bridge (scene_from_arrays) from a JAX DeviceScene.

Both packages build these scenes with the Karras path (below 50k
triangles) unless a test asks for SAH, so wide rows, treelet plans,
shading rows, material rows, atlas planes and emitter rows are exactly
equal. The env map's equal-area resample runs each framework's
sin/cos/atan2, so its texels agree to 1e-6 relative. The SAH builder's
binary arrays equal the reference's exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.accel import lbvh as JL
from moonshine_tpu.scene import procedural as JP
from moonshine_tpu_torch.accel import lbvh as PL
from moonshine_tpu_torch.scene import procedural as PP
from moonshine_tpu_torch.scene import world as PWorld
from moonshine_tpu_torch.scene.world import scene_from_arrays

from test_bvh import random_tris

ENV_TOL = dict(rtol=1e-6, atol=1e-7)
ENV_KEYS = ("env.rgbl", "env.select")


def jax_scene_arrays(js):
    """Flatten a moonshine_tpu DeviceScene into scene_from_arrays' dicts."""
    f = lambda x: np.asarray(x)
    arrays = {
        "wide.nodes": f(js.wide.nodes), "wide.leaves": f(js.wide.leaves),
        "wide.bounds": f(js.wide.bounds), "wide.t_roots": f(js.wide.t_roots),
        "wide.t_lo": f(js.wide.t_lo), "wide.t_hi": f(js.wide.t_hi),
        "tri_shade": f(js.tri_shade),
        "materials.packed": f(js.materials.packed),
        "mat_atlas.bsdf.data": f(js.mat_atlas.bsdf.data.astype(jnp.float32)),
        "mat_atlas.emissive.data": f(
            js.mat_atlas.emissive.data.astype(jnp.float32)),
        "env.rgbl": f(js.env.rgbl), "env.select": f(js.env.select),
        "env.alias": f(js.env.alias).astype(np.int64),
        "emitters.select": f(js.emitters.select),
        "emitters.alias": f(js.emitters.alias).astype(np.int64),
        "emitters.tri": f(js.emitters.tri).astype(np.int64),
        "emitters.rows": f(js.emitters.rows),
    }
    atlas = js.mat_atlas
    statics = {
        "wide.max_depth": js.wide.max_depth, "wide.width": js.wide.width,
        "wide.leaf_slots": js.wide.leaf_slots,
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


def build_pair(name):
    """(JAX DeviceScene, port World) of one scene."""
    if name == "flagship":
        from __graft_entry__ import _flagship_scene

        return _flagship_scene()[0], PP.flagship_scene()[0]
    jw, _ = JP.room_scene(grid=2, subdivisions=2)
    pw, _ = PP.room_scene(grid=2, subdivisions=2)
    return jw.build(), pw


def _scene_tensors(sc):
    """Every device tensor of a port DeviceScene, keyed like the arrays."""
    return {
        "wide.nodes": sc.wide.nodes, "wide.leaves": sc.wide.leaves,
        "wide.bounds": sc.wide.bounds, "wide.t_roots": sc.wide.t_roots,
        "wide.t_lo": sc.wide.t_lo, "wide.t_hi": sc.wide.t_hi,
        "tri_shade": sc.tri_shade,
        "materials.packed": sc.materials.packed,
        "mat_atlas.bsdf.data": sc.mat_atlas.bsdf.data,
        "mat_atlas.emissive.data": sc.mat_atlas.emissive.data,
        "env.rgbl": sc.env.rgbl, "env.select": sc.env.select,
        "env.alias": sc.env.alias, "emitters.select": sc.emitters.select,
        "emitters.alias": sc.emitters.alias, "emitters.tri": sc.emitters.tri,
        "emitters.rows": sc.emitters.rows,
    }


@pytest.mark.parametrize("name", ["flagship", "room"])
def test_world_build_matches_reference(name):
    js, pw = build_pair(name)
    want_arrays, want_statics = jax_scene_arrays(js)
    got = _scene_tensors(pw.build("cpu"))
    assert set(got) == set(want_arrays)
    for key, want in want_arrays.items():
        g = got[key]
        if g.dtype == torch.bfloat16:
            g = g.float()
        g = g.numpy()
        assert g.shape == want.shape, key
        if key in ENV_KEYS:
            np.testing.assert_allclose(g, want, **ENV_TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(g, want.astype(g.dtype),
                                          err_msg=key)
    _, got_statics = pw.build_arrays()
    for key, want in want_statics.items():
        if key == "env.integral":
            assert got_statics[key] == pytest.approx(want, rel=1e-6)
        else:
            assert got_statics[key] == want, key


@pytest.mark.parametrize("name", ["flagship", "room"])
def test_state_bridge(name):
    """scene_from_arrays of the JAX scene carries its arrays bit for bit
    and its static facts as plain attributes."""
    js, pw = build_pair(name)
    arrays, statics = jax_scene_arrays(js)
    bridged = scene_from_arrays(arrays, statics, "cpu")
    for key, t in _scene_tensors(bridged).items():
        t = t.float() if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(
            t.numpy(), arrays[key].astype(t.numpy().dtype), err_msg=key)
    native = pw.build("cpu")
    tensors = dict(nodes=None, leaves=None, bounds=None, t_roots=None,
                   t_lo=None, t_hi=None)
    assert bridged.wide._replace(**tensors) == native.wide._replace(**tensors)
    assert bridged.mat_atlas.bsdf_constant == native.mat_atlas.bsdf_constant
    assert bridged.mat_atlas.normals_flat == native.mat_atlas.normals_flat
    assert bridged.emitters.count == native.emitters.count
    assert bridged.has_delta == native.has_delta is True
    assert bridged.env.size == native.env.size
    assert bridged.wide.max_stack == js.wide.max_stack


@pytest.mark.parametrize("n_tris,seed", [(3, 0), (37, 1), (700, 2),
                                         (2000, 3)])
def test_build_sah_matches_reference(n_tris, seed):
    """Every array of the binned-SAH binary tree equals the reference's
    (built without its power-of-two padding, which the port drops)."""
    tris = random_tris(n_tris, seed=seed)
    want = JL.build_sah(tris, as_numpy=True, pad_nodes_to_pow2=False)
    got = PL.build_sah(tris)
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def _room_rows(arrays):
    return {k: v for k, v in arrays.items() if k.startswith("wide.")}


def test_world_sah_rows_match_reference():
    """World.build_arrays(builder="sah") rows equal the JAX
    World.build(builder="sah") rows on the small room."""
    jw, _ = JP.room_scene(grid=2, subdivisions=2)
    pw, _ = PP.room_scene(grid=2, subdivisions=2)
    want, want_s = jax_scene_arrays(jw.build(builder="sah"))
    got, got_s = pw.build_arrays(builder="sah")
    for key, w in _room_rows(want).items():
        np.testing.assert_array_equal(got[key], w.astype(got[key].dtype),
                                      err_msg=key)
    for key in ("wide.max_depth", "wide.width", "wide.leaf_slots"):
        assert got_s[key] == want_s[key], key


def test_auto_builder_switches_to_sah(monkeypatch):
    """builder="auto" builds SAH above SAH_MIN_TRIS triangles (50k, the
    reference's rule) and Karras at or below it."""
    pw, _ = PP.room_scene(grid=2, subdivisions=1)
    built = []
    for name in ("build", "build_sah"):
        fn = getattr(PWorld.lbvh, name)
        monkeypatch.setattr(
            PWorld.lbvh, name,
            lambda *a, _fn=fn, _name=name, **k: built.append(_name)
            or _fn(*a, **k))
    arrays, _ = pw.build_arrays()
    n_tris = len(arrays["tri_shade"])
    monkeypatch.setattr(PWorld, "SAH_MIN_TRIS", n_tris)
    pw.build_arrays()
    monkeypatch.setattr(PWorld, "SAH_MIN_TRIS", n_tris - 1)
    pw.build_arrays()
    assert PWorld.SAH_MIN_TRIS == n_tris - 1
    assert built == ["build", "build", "build_sah"]
    with pytest.raises(ValueError, match="unknown builder"):
        pw.build_arrays(builder="median")


def test_wide_layout_overrides_match_reference(monkeypatch):
    """MSN_WIDE=8 MSN_LEAF_CAP=8 give the 8-wide / 8-slot tree in both
    packages, with the same rows and treelet plan."""
    monkeypatch.setenv("MSN_WIDE", "8")
    monkeypatch.setenv("MSN_LEAF_CAP", "8")
    jw, _ = JP.room_scene(grid=2, subdivisions=2)
    pw, _ = PP.room_scene(grid=2, subdivisions=2)
    want, want_s = jax_scene_arrays(jw.build(builder="sah"))
    got, got_s = pw.build_arrays(builder="sah")
    assert (got_s["wide.width"], got_s["wide.leaf_slots"]) == (8, 8)
    assert (want_s["wide.width"], want_s["wide.leaf_slots"]) == (8, 8)
    for key, w in _room_rows(want).items():
        np.testing.assert_array_equal(got[key], w.astype(got[key].dtype),
                                      err_msg=key)


def test_build_defaults_to_the_card():
    """World.build, build_wide, LensArrays.from_lens and Sensor.create put
    their tensors on "cuda" unless asked for another device."""
    import inspect

    from moonshine_tpu_torch.accel.wide import build_wide
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.sensor import Sensor

    for fn in (PWorld.World.build, build_wide, LensArrays.from_lens,
               Sensor.create):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_flatten_cap_reads_the_variable(monkeypatch):
    """MSN_MAX_FLAT_TRIS sets the flatten cap at each build, as in the
    reference (world.py:350): below the scene's triangle count the build
    warns and builds the two-level scene, at the count it builds the same
    arrays as under the default cap."""
    pw, _ = PP.room_scene(grid=2, subdivisions=1)
    want, want_s = pw.build_arrays()
    n_tris = len(want["tri_shade"])
    monkeypatch.setenv("MSN_MAX_FLAT_TRIS", str(n_tris - 1))
    with pytest.warns(UserWarning, match=f"cap {n_tris - 1:,}"):
        two_level, _ = pw.build_arrays()
    assert "tlas.top_min" in two_level and "wide.nodes" not in two_level
    monkeypatch.setenv("MSN_MAX_FLAT_TRIS", str(n_tris))
    got, got_s = pw.build_arrays()
    assert got_s == want_s and set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
