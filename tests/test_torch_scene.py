"""The port's World.build against moonshine_tpu's, leaf for leaf, and the
state bridge (scene_from_arrays) from a JAX DeviceScene.

Both packages build these scenes with the Karras path (below 50k
triangles), so wide rows, shading rows, material rows, atlas planes and
emitter rows are exactly equal. The env map's equal-area resample runs
each framework's sin/cos/atan2, so its texels agree to 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.scene import procedural as JP
from moonshine_tpu_torch.scene import procedural as PP
from moonshine_tpu_torch.scene.world import scene_from_arrays

ENV_TOL = dict(rtol=1e-6, atol=1e-7)
ENV_KEYS = ("env.rgbl", "env.select")


def jax_scene_arrays(js):
    """Flatten a moonshine_tpu DeviceScene into scene_from_arrays' dicts."""
    f = lambda x: np.asarray(x)
    arrays = {
        "wide.nodes": f(js.wide.nodes), "wide.leaves": f(js.wide.leaves),
        "wide.bounds": f(js.wide.bounds), "tri_shade": f(js.tri_shade),
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
        "wide.bounds": sc.wide.bounds, "tri_shade": sc.tri_shade,
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
    assert bridged.wide._replace(nodes=None, leaves=None, bounds=None) == \
        native.wide._replace(nodes=None, leaves=None, bounds=None)
    assert bridged.mat_atlas.bsdf_constant == native.mat_atlas.bsdf_constant
    assert bridged.mat_atlas.normals_flat == native.mat_atlas.normals_flat
    assert bridged.emitters.count == native.emitters.count
    assert bridged.has_delta == native.has_delta is True
    assert bridged.env.size == native.env.size
    assert bridged.wide.max_stack == js.wide.max_stack
