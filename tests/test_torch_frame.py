"""A sample's stages around the bounce loop (render/frame_kernels.py: the
camera rays with the fresh lane state, the accumulation) and the loop's
counts (integrator/path.py, integrator/shade.py), their plain versions
on the CPU against the JAX package.

Inputs are the reference's lens arrays and seeded numpy arrays handed to
both packages. The camera rays against the reference's `_sample_rays` /
`_sample_rays_batched` (moonshine_tpu/render/renderer.py:126-155): the
PCG states bit for bit, o and d within 2e-6 absolute plus 2e-6 relative
(the port's CPU sin, cos, log, tan and sqrt round once from float64, the
reference's are XLA's float32 functions: an ulp or two apart), in
scanline and tiled order, a band below the first row, three samples a
batch, flipped or not, with and without an aperture. The accumulation
against `_staged_accum` after the resort's scatter by pix, one and three
samples a batch: bit for bit (the batch summed left to right). The
counts of a traced 16x16 sample of the flagship, each segment's live
lanes and the rays so far, against the reference's staged loop (its
`_staged_bounce` a segment) within the repo's 1% bar on rays
(tests/test_torch_render.py; the frameworks round a lane's path
differently now and then), and exactly against the sums of the port's
own masks (the lanes live at each segment's start, the shadow rays
set), in the unrolled and looped forms, resorted or not. And every C
entry point that accel/native.py binds takes as many ctypes arguments as
its definition has parameters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonshine_tpu.render import camera as JC
from moonshine_tpu.render import renderer as JR
from moonshine_tpu.scene.types import Lens as JaxLens
from moonshine_tpu_torch.integrator import path as P
from moonshine_tpu_torch.integrator import shade
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.render import frame_kernels as FK
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.scene import procedural

LENSES = {
    "pinhole": dict(origin=[0.3, -4.0, 1.2], forward=[0.05, 1.0, -0.1],
                    up=[0.0, 0.0, 1.0], vfov=0.9, aperture=0.0,
                    focus_distance=1.0),
    "aperture": dict(origin=[-1.0, -3.5, 0.8], forward=[0.2, 0.9, 0.1],
                     up=[0.1, 0.0, 1.0], vfov=0.7, aperture=0.25,
                     focus_distance=3.2),
}


def _lenses(name):
    f32 = {k: np.float32(v) for k, v in LENSES[name].items()}
    jax_lens = JC.LensArrays.from_lens(JaxLens(**f32))
    port = LensArrays(*(torch.tensor(np.asarray(getattr(jax_lens, k)))
                        for k in LensArrays._fields))
    return jax_lens, port


def _trace(n):
    return P._Trace(n, "cpu", PathConfig(), resort=True, unroll=True,
                    sort_first=False, capture=False)


# (height, width, y0, bh, nbatch), flipped, lens: scanline, tiled
# (128x256), a scanline band and a tiled band below the first row, three
# samples a batch tiled; flip on and off, aperture 0 and > 0
CASES = {"scanline": ((48, 80, 0, 48, 1), True, "aperture"),
         "tiled": ((128, 256, 0, 128, 1), False, "aperture"),
         "band": ((96, 80, 32, 40, 1), True, "pinhole"),
         "tiled_band": ((128, 128, 64, 64, 1), False, "pinhole"),
         "batch3": ((64, 128, 0, 64, 3), True, "aperture")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_raygen_plain_matches_reference(case):
    """The camera rays of nbatch samples from sample 5 in the trace's
    first buffers, against the reference's rays of the whole frame (the
    band's lanes a slice of them: a band of whole tiles or rows keeps
    the frame's order), and the fresh state of _init_state with the
    trace's scalars."""
    (height, width, y0, bh, nbatch), flip, lens = CASES[case]
    jax_lens, port_lens = _lenses(lens)
    if nbatch > 1:
        want = JR._sample_rays_batched(jax_lens, height, width, 5, nbatch,
                                       flip)
    else:
        want = JR._sample_rays(jax_lens, height, width, 5, flip)
        lo = y0 * width
        want = [x[lo:lo + bh * width] for x in want]
    o, d, rng = (np.asarray(x) for x in want)
    n = nbatch * bh * width
    trace = _trace(n)
    FK.raygen(port_lens, torch.tensor(5), height, width, y0, bh, nbatch,
              flip, trace)
    st = trace.bufs[0]
    np.testing.assert_array_equal(st["rng"].numpy(), rng.astype(np.int64))
    for got, ref in ((st["o"], o), (st["d"], d)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6)
    fresh = P._init_state(st["o"], st["d"], st["rng"])
    for k, v in fresh.items():
        assert torch.equal(st[k], v), k
    assert int(trace.live) == n and int(trace.bounce) == 0
    assert trace.widx.tolist() == [2, 2]
    if case == "band":  # the wrapper of one sample's rays: the same rays
        got = FK.sample_rays(port_lens, height, width, 5, flip, "cpu", y0,
                             bh)
        for a, b in zip(got[:3], (st["o"], st["d"], st["rng"])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("hw", [(48, 80), (128, 256)])
def test_accumulate_plain_matches_reference(hw, nbatch):
    """acc [h, w, 4] += a trace's radiance under the resort's lane order
    (pix a seeded permutation), summed over its samples, against the
    reference's scatter by pix (_staged_finish) and _staged_accum, bit
    for bit on the first three floats of each pixel, the fourth as it
    was; and without pix against the same radiance in lane order. The
    tally: the frame's rays plus the trace's, as _staged_accum adds
    them, its segments plus the trace's bounce count, its sample index
    plus nbatch."""
    from moonshine_tpu.integrator import path as JP

    h, w = hw
    n = nbatch * h * w
    rs = np.random.RandomState(11)
    acc0 = rs.rand(h, w, 4).astype(np.float32)
    rad = (rs.rand(n, 3) * 10.0 ** rs.randint(-3, 3, (n, 1))).astype(
        np.float32)
    pix = rs.permutation(n)
    trace_rays, rays0 = 7 * n + 5, 123456
    ordered, _, j_rays = JP._staged_finish(
        {"radiance": jnp.asarray(rad), "pix": jnp.asarray(pix),
         "rng": jnp.zeros(n, jnp.uint32), "rays": jnp.int32(trace_rays)},
        resort=True)
    for lanes, p in ((rad, pix), (np.array(ordered), None)):
        want, want_rays = JR._staged_accum(
            jnp.asarray(acc0[..., :3]), jnp.int32(rays0), ordered, j_rays,
            h, w)
        acc = torch.from_numpy(acc0.copy())
        i64 = lambda v: torch.tensor(v, dtype=torch.int64)
        tally = FK.Tally(rays=i64(rays0), trace_rays=i64(trace_rays),
                         segments=i64(40), bounce=i64(6), sample=i64(9))
        FK.accumulate(acc, torch.from_numpy(lanes),
                      None if p is None else torch.from_numpy(p), nbatch,
                      tally)
        np.testing.assert_array_equal(acc[..., :3].numpy(), np.asarray(want))
        np.testing.assert_array_equal(acc[..., 3].numpy(), acc0[..., 3])
        assert int(tally.rays) == int(want_rays)
        assert (int(tally.segments), int(tally.sample)) == (46, 9 + nbatch)
        assert (int(tally.trace_rays), int(tally.bounce)) == (trace_rays, 6)


CFG = dict(max_bounces=4, env_samples_per_bounce=1,
           mesh_samples_per_bounce=1)


@pytest.fixture(scope="module")
def jax_counts():
    """The reference's staged loop (its `_staged_bounce` a segment) on the
    flagship's 16x16 camera rays of sample 2, made by the port's camera:
    each segment's live lanes and the rays so far. Its traversal goes
    through its own jnp walk (`_hbm_mode` "jnp"), which finds the
    packet kernel's hits and compiles several times faster than that
    kernel in interpret mode; no resort (the counts do not depend on the
    lane order)."""
    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator import path as JP

    js, _ = _flagship_scene()
    _, port_lens = _flagship()
    o, d, rng, _ = FK.sample_rays(port_lens, 16, 16, 2, True, "cpu")
    cfg = JP.PathConfig(**CFG, resort_bounces=False)
    st = JP._init_state(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                        jnp.asarray(rng.numpy().astype(np.uint32)))
    out = []
    segments = cfg.max_bounces + 2
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JP, "_hbm_mode", lambda wide: "jnp")
        for b in range(segments):
            st = JP._staged_bounce(js, st, jnp.asarray(b, jnp.int32), cfg,
                                   resort=False, last=b == segments - 1)
            out.append((int(jnp.sum(st["active"])), float(st["rays"])))
    return out


def _flagship():
    world, lens = procedural.flagship_scene()
    return world.build("cpu"), LensArrays.from_lens(lens, "cpu")


@pytest.mark.parametrize("unroll,resort", [(True, True), (False, False)])
def test_counts_match_reference(jax_counts, monkeypatch, unroll, resort):
    """The port's trace of the same sample: after each segment its live
    count and rays against the reference's (1% bar) and against its own
    masks exactly (the lanes live at the segment's start plus the shadow
    rays its surface set; the lanes its state leaves live)."""
    scene, lens = _flagship()
    cfg = PathConfig(**CFG, unroll=unroll, resort_bounces=resort)
    expect = {"rays": 0}
    seen = []
    body, surface = P._bounce_body, shade.surface

    def counted_surface(*args, **kw):
        surf = surface(*args, **kw)
        if surf.shadow is not None:
            expect["rays"] += int(surf.shadow.lane.sum())
        return surf

    def counted_body(scene, cfg, bounce, st, **kw):
        expect["rays"] += int(st["active"].sum())
        out = body(scene, cfg, bounce, st, **kw)
        seen.append((int(kw["live"]), int(out["rays"]),
                     int(out["active"].sum()), expect["rays"]))
        return out

    monkeypatch.setattr(P, "_bounce_body", counted_body)
    monkeypatch.setattr(shade, "surface", counted_surface)
    camera = FK.sample_rays(lens, 16, 16, 2, True, "cpu")[:3]
    _, _, rays, segments = P.trace_paths(scene, *camera, cfg)
    assert segments == len(seen) == len(jax_counts) == 6
    for (live, n_rays, want_live, want_rays), (j_live, j_rays) in zip(
            seen, jax_counts):
        assert (live, n_rays) == (want_live, want_rays)
        assert abs(live - j_live) <= 0.01 * max(j_live, 1)
        assert abs(n_rays / j_rays - 1.0) <= 1e-2
    assert int(rays) == seen[-1][1]


class _FakeFn:
    """A C entry point as ctypes binds it, without the library."""

    argtypes = restype = None

    def __call__(self, *args):
        return 1


class _FakeLib:
    def __init__(self, path):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _FakeFn())


def test_bindings_take_every_parameter(monkeypatch):
    """Each entry point native.py binds takes as many ctypes arguments as
    its C definition has parameters (one more or fewer shifts the stream
    argument, which ctypes then passes as a 32-bit int): the
    `extern "C"` signatures of every source against each library class's
    argtypes."""
    import re

    from moonshine_tpu_torch.accel import native

    monkeypatch.setattr(native.ctypes, "CDLL", _FakeLib)
    checked = 0
    for name, cls in native._CLASSES.items():
        lib = cls(native.SOURCES[name], 0.0, "")
        source = native.SOURCES[name].read_text()
        for macro, body in re.findall(r"#define (\w+)\s+((?:.*\\\n)*.*)",
                                      source):  # parameter-list macros
            source = source.replace(f"({macro},", f"({body},")
        for fn_name, fn in lib._lib.fns.items():
            if fn.argtypes is None:
                continue
            m = re.search(rf"\b{fn_name}\s*\(([^)]*)\)\s*\{{", source)
            assert m, f"{fn_name} not defined in {native.SOURCES[name]}"
            params = [p for p in m.group(1).split(",") if p.strip()
                      and p.strip() != "void"]
            assert len(fn.argtypes) == len(params), fn_name
            checked += 1
    assert checked >= 25
