"""The large-scene path of the port on the CPU: the per-bounce coherence
resort and live-prefix shrink, the staged per-bounce path, banded
sampling, and the traversal dispatch (`_hbm_mode`) with its treelet and
HBM-class modes, against the port's own fused path and against
moonshine_tpu.

Tolerances: moving lanes changes no lane's result, so the resort, the
staged path and banding are bit-equal to the plain fused render (lane
counts here are multiples of 64, so every lane takes torch's vectorised
CPU loops; a lane in a loop's scalar tail may round atan2 or pow one ulp
differently). Against the JAX package the image bar of
tests/test_torch_render.py holds: >= 99% of pixels within 1e-3 (abs +
rel) and means within 1e-3 relative. Two trees of one scene agree to the
same bar (only equal-t ties may send a lane elsewhere)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu_torch.accel import packet as PP
from moonshine_tpu_torch.accel import treelet as PT
from moonshine_tpu_torch.integrator import path as P
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.render import renderer as R
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.scene import procedural

from test_torch_render import assert_image_close

CFG = dict(max_bounces=4, env_samples_per_bounce=1,
           mesh_samples_per_bounce=1)


def _port(make, builder="auto"):
    world, lens = make()
    return world.build("cpu", builder), LensArrays.from_lens(lens, "cpu")


def _room():
    return procedural.room_scene(grid=2, subdivisions=2)


@pytest.mark.parametrize("unroll", [True, False])
def test_resort_is_bit_equal(unroll):
    """64x64 = 4096 lanes: the resorted state runs deep bounces over a
    half or a quarter prefix, and the image equals the unsorted one."""
    scene, lens = _port(procedural.flagship_scene)
    imgs = {}
    for resort in (False, True):
        stats = {}
        imgs[resort] = R.render_spp(
            scene, lens, 64, 64, 5, 1,
            PathConfig(**CFG, unroll=unroll, resort_bounces=resort),
            stats=stats)
        assert stats["resort"] is resort and stats["path"] == "fused"
    (a, ra), (b, rb) = imgs[False], imgs[True]
    assert torch.equal(a, b)
    assert int(ra) == int(rb) > 0


def test_bounce_shrunk_runs_on_the_live_prefix(monkeypatch):
    """With few live lanes the bounce body sees a quarter of the batch."""
    scene, lens = _port(procedural.flagship_scene)
    o, d, rng, _ = R._sample_rays(lens, 64, 64, 0, True, "cpu")
    st = P._init_state(o, d, rng)
    st["active"] = torch.arange(4096) % 5 == 0  # 820 live <= 1024
    st = P._resort_state(scene, st)
    assert st["active"][:820].all() and not st["active"][820:].any()
    seen = []
    body = P._bounce_body
    monkeypatch.setattr(P, "_bounce_body", lambda sc, cfg, b, s, **k:
                        seen.append(s["o"].shape[0]) or body(sc, cfg, b, s,
                                                             **k))
    before = {k: v.clone() for k, v in st.items()}
    width = P._prefix_width(4096, 820)
    out = P._bounce_shrunk(scene, PathConfig(**CFG), 1, st, last=False,
                           width=width)
    assert seen == [1024] and width == 1024
    assert torch.equal(out["radiance"][1024:], before["radiance"][1024:])
    assert torch.equal(out["pix"], before["pix"])


def test_resort_state_matches_reference():
    """The port's resort orders lanes as the reference's does (8^3 cells x
    octant, dead lanes last, stable)."""
    from moonshine_tpu.integrator import path as JP_path

    scene, _ = _port(_room)
    rs = np.random.RandomState(3)
    n = 4096
    lo, hi = (scene.wide.bounds.numpy()[0], scene.wide.bounds.numpy()[1])
    o = (lo + rs.rand(n, 3) * (hi - lo)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    active = rs.rand(n) > 0.3

    class JaxScene:
        wide = scene.wide._replace(bounds=jnp.asarray(
            scene.wide.bounds.numpy()))

    want = JP_path._resort_state(JaxScene, dict(
        o=jnp.asarray(o), d=jnp.asarray(d), active=jnp.asarray(active),
        pix=jnp.arange(n, dtype=jnp.int32)))
    got = P._resort_state(scene, dict(
        o=torch.from_numpy(o), d=torch.from_numpy(d),
        active=torch.from_numpy(active), pix=torch.arange(n)))
    np.testing.assert_array_equal(got["pix"].numpy(), np.asarray(want["pix"]))


def _full_state(scene, n, seed, dead_past=None, live=0.7):
    """Every column of a lane state (numpy, the port's dtypes), seeded:
    a `live` share of the lanes live, none past `dead_past`."""
    rs = np.random.RandomState(seed)
    lo, hi = (scene.wide.bounds.numpy()[0], scene.wide.bounds.numpy()[1])
    active = rs.rand(n) < live
    if dead_past is not None:
        active[dead_past:] = False
    return dict(
        active=active, o=(lo + rs.rand(n, 3) * (hi - lo)).astype(np.float32),
        d=rs.randn(n, 3).astype(np.float32),
        throughput=rs.rand(n, 3).astype(np.float32),
        radiance=rs.rand(n, 3).astype(np.float32),
        last_pdf=rs.rand(n).astype(np.float32),
        last_delta=rs.rand(n) > 0.5,
        rng=rs.randint(0, 2**32, n).astype(np.int64),
        rays=np.int64(12345), pix=rs.permutation(n).astype(np.int64))


def test_resort_state_moves_every_column_as_reference():
    """Every column of the state (17 scalars a lane: the mask, ray,
    throughput, radiance, pdf, delta flag, RNG state and pixel id) moved
    as the reference's one multi-operand sort moves it, bit for bit; the
    ray count stays."""
    from moonshine_tpu.integrator import path as JP_path

    scene, _ = _port(_room)
    st = _full_state(scene, 4096, 5)

    class JaxScene:
        wide = scene.wide._replace(bounds=jnp.asarray(
            scene.wide.bounds.numpy()))

    jax_dtypes = dict(rng=np.uint32, pix=np.int32, rays=np.float32)
    want = JP_path._resort_state(JaxScene, {
        k: jnp.asarray(v.astype(jax_dtypes.get(k, v.dtype)))
        for k, v in st.items()})
    got = P._resort_state(scene, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in st.items()})
    assert set(got) == set(st)
    for k in st:
        assert got[k].dtype == torch.from_numpy(np.asarray(st[k])).dtype
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).astype(
                                          np.asarray(st[k]).dtype), k)


@pytest.mark.parametrize("prefix,width", [(4096, 4096), (4096, 1024),
                                          (2048, 1024), (2048, 2048)])
def test_resort_into_the_other_buffers(prefix, width):
    """The loop's resort (out=, prefix, width): sorting only the first
    `prefix` lanes, every lane past them dead, gives the full resort's
    order; each array's first `width` lanes and the tail arrays whole
    (_TAIL) land in `out`, nothing else of it is written."""
    scene, _ = _port(_room)
    n = 4096
    st = {k: torch.from_numpy(np.asarray(v)) for k, v in _full_state(
        scene, n, 6, dead_past=prefix, live=0.9 * width / prefix).items()}
    live = int(st["active"].sum())
    assert live <= width
    want = P._resort_state(scene, st)
    out = {k: (v if k == "rays" else torch.full_like(v, 7))
           for k, v in st.items()}
    before = {k: v.clone() for k, v in out.items()}
    got = P._resort_state(scene, st, out=out, prefix=prefix, width=width)
    assert all(got[k] is out[k] for k in st)
    assert got["rays"] is st["rays"]
    for k, v in want.items():
        if k == "rays":
            continue
        rows = n if k in P._TAIL else width
        assert torch.equal(got[k][:rows], v[:rows]), k
        assert torch.equal(got[k][rows:], before[k][rows:]), k
    assert not got["active"][live:].any()


def test_resort_matches_reference():
    """The small room rendered with resort_bounces=True by both
    packages."""
    from moonshine_tpu.integrator.path import PathConfig as JaxPathConfig
    from moonshine_tpu.render.camera import LensArrays as JaxLens
    from moonshine_tpu.render.renderer import render_spp as jax_render_spp
    from moonshine_tpu.scene import procedural as JP

    jw, jl = JP.room_scene(grid=2, subdivisions=2)
    cfg = dict(CFG, resort_bounces=True)
    want, _ = jax_render_spp(jw.build(), JaxLens.from_lens(jl), 32, 32, 0,
                             1, JaxPathConfig(**cfg))
    scene, lens = _port(_room)
    got, _ = R.render_spp(scene, lens, 32, 32, 0, 1, PathConfig(**cfg))
    assert np.isfinite(got.numpy()).all()
    assert_image_close(got.numpy(), np.asarray(want))


def test_staged_is_bit_equal_to_fused(monkeypatch):
    """Above MAX_LANES render_spp takes the staged path; with both samples
    batched onto one 2048-lane dispatch it gives the fused image."""
    scene, lens = _port(procedural.flagship_scene)
    cfg = PathConfig(**CFG)
    fused_stats, staged_stats = {}, {}
    want, want_rays = R.render_spp(scene, lens, 32, 32, 2, 2, cfg,
                                   stats=fused_stats)
    monkeypatch.setattr(R, "MAX_LANES", 512)
    got, rays = R.render_spp(scene, lens, 32, 32, 2, 2, cfg,
                             stats=staged_stats)
    assert staged_stats == dict(path="staged", resort=True, segments=6)
    assert fused_stats == dict(path="fused", resort=True, segments=12)
    assert torch.equal(got, want)
    assert int(rays) == int(want_rays)
    one, _ = R._render_spp_staged(scene, lens, 32, 32, 2, 2, cfg, batch=1)
    assert torch.equal(one, want)


def test_staged_matches_reference():
    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator.path import PathConfig as JaxPathConfig
    from moonshine_tpu.render.camera import LensArrays as JaxLens
    from moonshine_tpu.render.renderer import (
        _render_spp_staged as jax_staged,
    )

    js, jlens = _flagship_scene()
    want, want_rays = jax_staged(js, JaxLens.from_lens(jlens), 32, 32, 0, 1,
                                 JaxPathConfig(**CFG), True)
    scene, lens = _port(procedural.flagship_scene)
    got, rays = R._render_spp_staged(scene, lens, 32, 32, 0, 1,
                                     PathConfig(**CFG))
    assert_image_close(got.numpy(), np.asarray(want))
    assert abs(int(rays) / float(want_rays) - 1.0) <= 1e-2


def test_bands_tile_the_frame():
    """render_sample over row bands [y0, y0 + band_h) stacks to the full
    frame, bit for bit."""
    scene, lens = _port(procedural.flagship_scene)
    cfg = PathConfig(**CFG)
    full, rays = R.render_sample(scene, lens, 32, 32, 4, cfg)
    bands = [R.render_sample(scene, lens, 32, 32, 4, cfg, y0=y0, band_h=8)
             for y0 in range(0, 32, 8)]
    assert torch.equal(torch.cat([b[0] for b in bands]), full)
    assert sum(int(b[1]) for b in bands) == int(rays)


def test_dispatch_modes(monkeypatch):
    """_hbm_mode picks as the reference: 'vmem' for rows within the
    budget, 'hbm' beyond it, 'treelet' beyond it with MSN_TREELETS=1 on an
    8-wide / 8-slot tree; an HBM-class stack bound over the HBM limit
    takes the per-lane walk ('lanes', the reference's 'jnp'), and so does
    a scene without a wide tree."""
    scene, _ = _port(_room)
    wide = scene.wide
    assert P._hbm_mode(wide) == "vmem"
    monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 0)
    assert P._hbm_mode(wide) == "hbm"
    monkeypatch.setenv("MSN_TREELETS", "1")
    assert P._hbm_mode(wide) == "hbm"  # 16-wide: no treelet kernel
    monkeypatch.setenv("MSN_WIDE", "8")
    monkeypatch.setenv("MSN_LEAF_CAP", "8")
    world, _ = _room()
    arrays, statics = world.build_arrays()
    from moonshine_tpu_torch.accel import wide as PW

    w8 = PW.build_wide(arrays["tri_shade"][:, 0:9].reshape(-1, 3, 3),
                       leaf_cap=8, width=8, device="cpu", max_rows=48)
    assert PT.available(w8) and P._hbm_mode(w8) == "treelet"
    deep = wide._replace(max_depth=20)  # bound 15 * 20 + 1 = 301
    assert P._hbm_mode(deep) == "lanes"
    assert P._hbm_mode(None) == "lanes"
    monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 10 * 1024 * 1024)
    assert P._hbm_mode(deep) == "vmem"  # VMEM-class scenes hold 512


def test_treelet_mode_render(monkeypatch):
    """The small room as an 8-wide / 8-slot tree of 48-row treelets
    treated as HBM-class: with MSN_TREELETS=1 every closest and any hit
    goes through the treelet traversal, and the image agrees with the
    16-wide packet render."""
    from moonshine_tpu_torch.accel import wide as PW

    scene16, lens = _port(_room)
    want, _ = R.render_spp(scene16, lens, 32, 32, 0, 1, PathConfig(**CFG))
    monkeypatch.setenv("MSN_TREELETS", "1")
    monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 0)
    verts = scene16.tri_shade[:, 0:9].reshape(-1, 3, 3).numpy()
    scene8 = scene16._replace(wide=PW.build_wide(
        verts, leaf_cap=8, width=8, device="cpu", max_rows=48))
    calls = []
    run = PT._run
    monkeypatch.setattr(PT, "_run", lambda *a, **k: calls.append(a[5])
                        or run(*a, **k))
    packet_calls = []
    for name in ("closest_hit_packet", "any_hit_packet"):
        fn = getattr(PP, name)
        monkeypatch.setattr(PP, name, lambda *a, _fn=fn, **k:
                            packet_calls.append(1) or _fn(*a, **k))
    stats = {}
    got, _ = R.render_spp(scene8, lens, 32, 32, 0, 1, PathConfig(**CFG),
                          stats=stats)
    assert P._hbm_mode(scene8.wide) == "treelet"
    assert calls.count(False) == stats["segments"] == 6
    assert calls.count(True) == 5 and not packet_calls
    assert_image_close(got.numpy(), want.numpy())


def test_resolve_resort_rules(monkeypatch):
    """The reference's resort choice: as configured, else on for VMEM-class
    scenes with a mirror or glass, and for HBM-class ones up to 600k lanes
    in trace_paths and at any lane count in the staged path; never for the
    per-lane walk."""
    furnace, _ = _port(procedural.furnace_scene)
    room, _ = _port(_room)
    auto = PathConfig(**CFG)
    assert room.has_delta and not furnace.has_delta
    assert P._resolve_resort(room, auto, 4096)
    assert not P._resolve_resort(furnace, auto, 4096)
    assert not P._resolve_resort(room, PathConfig(**CFG, resort_bounces=False))
    monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 0)
    assert P._resolve_resort(room, auto, 600_000)
    assert not P._resolve_resort(room, auto, 600_001)
    assert P._resolve_resort(room, auto)  # staged
    assert P._resolve_resort(room, PathConfig(**CFG, resort_bounces=True),
                             600_001)
    monkeypatch.setattr(PP, "HBM_STACK_DEPTH", 1)  # the per-lane walk
    assert P._hbm_mode(room.wide) == "lanes"
    assert not P._resolve_resort(room, auto, 4096)
    assert not P._resolve_resort(room, auto)


def test_shadow_compact_is_bit_equal(monkeypatch):
    """MSN_SHADOW_COMPACT=1 on a resorted HBM-class scene with a mirror and
    glass: the shadow batch sorts inside the any-hit dispatch, and the
    image is the one without it."""
    scene, lens = _port(procedural.flagship_scene)
    monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 0)
    sorts = []
    any_hbm = PP.any_hit_packet_hbm
    monkeypatch.setattr(PP, "any_hit_packet_hbm", lambda *a, **k:
                        sorts.append(k["sort"]) or any_hbm(*a, **k))
    cfg = PathConfig(**CFG, resort_bounces=True)
    imgs = []
    for flag in ("0", "1"):
        monkeypatch.setenv("MSN_SHADOW_COMPACT", flag)
        imgs.append(R.render_spp(scene, lens, 64, 64, 3, 1, cfg)[0])
    assert sorts == [False] * 5 + [True] * 5
    assert torch.equal(imgs[0], imgs[1])
