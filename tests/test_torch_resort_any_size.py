"""The bounce loop's resort at any lane count on the CPU
(integrator/path.py `_resolve_resort`, `_Trace._segment`): the looped
form that the offline CLI and the Engine run (max_bounces 1024), its
live-prefix widths chosen on the device.

Tolerances: moving lanes changes no lane's result, so the looped form
with the resort equals it without, bit for bit (lane counts and every
width are multiples of 64, so every lane takes torch's vectorised CPU
loops), and every branch of the width switch equals the full-width one.
Against the JAX package the image bar of tests/test_torch_render.py
holds: >= 99% of pixels within 1e-3 (abs + rel), means within 1e-3
relative, rays within 1%."""

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.accel import packet as PP
from moonshine_tpu_torch.integrator import path as P
from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.render import renderer as RR
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.scene import procedural

from test_torch_render import assert_image_close

LOOPED = dict(max_bounces=1024, env_samples_per_bounce=1,
              mesh_samples_per_bounce=1, unroll=False)


def _flagship():
    world, lens = procedural.flagship_scene()
    return world.build("cpu"), LensArrays.from_lens(lens, "cpu")


@pytest.mark.parametrize("hbm", [False, True])
def test_looped_resort_equals_no_resort(monkeypatch, hbm):
    """The looped form (max_bounces 1024, as the offline CLI and the
    Engine run) of the flagship at 64x64 with the resort auto and off:
    auto resorts (VMEM-class with a mirror; HBM-class when its rows are
    taken past the VMEM budget, as room_184k's are on the card), its
    deep segments run over the narrowest prefix, n/4, and radiance, rays
    and segments are bit-equal."""
    if hbm:
        monkeypatch.setattr(PP, "VMEM_SCENE_BUDGET_BYTES", 0)
    scene, lens = _flagship()
    assert P._hbm_mode(scene.wide) == ("hbm" if hbm else "vmem")
    o, d, rng, _ = RR._sample_rays(lens, 64, 64, 1, True, "cpu")
    taken = []
    resorted = P._Trace._resorted
    monkeypatch.setattr(P._Trace, "_resorted", lambda self, *a: (
        taken.append(a[3]) or resorted(self, *a)))
    runs = {}
    for resort in (None, False):
        cfg = PathConfig(**LOOPED, resort_bounces=resort)
        assert P._resolve_resort(scene, cfg) is (resort is None)
        runs[resort] = P.trace_paths(scene, o, d, rng, cfg)
    (ra, _, na, sa), (rb, _, nb, sb) = runs[None], runs[False]
    assert torch.equal(ra, rb)
    assert int(na) == int(nb) > 0 and sa == sb > 6
    assert len(taken) == sa - 1  # every segment after the first resorted
    assert min(taken) == 4096 // 4


def test_every_width_branch_equals_the_full_width(monkeypatch):
    """Each (prefix, width) branch of a resorted segment's switch at the
    three widths of 4096 lanes: from a state whose live lanes (exactly
    the width's count) lie in the prefix, the segment chooses that
    branch on the device (`_width_index` into widx equals the host's
    `_prefix_width`) and leaves what the full-width branch leaves: the
    radiance and the masks of every pixel, and the lanes that stay live
    (position, direction, throughput, PCG state), the ray and live
    counts."""
    scene, lens = _flagship()
    n = 64 * 64
    widths = P._widths(n)
    assert len(widths) == 3 and n >= P._SHRINK_MIN
    o, d, rng, _ = RR._sample_rays(lens, 64, 64, 2, True, "cpu")
    cfg = PathConfig(**LOOPED)
    gen = np.random.RandomState(5)

    def run(p, k, full):
        tr = P._Trace(n, "cpu", cfg, resort=True, unroll=False,
                      sort_first=False, capture=False)
        st = tr.bufs[1]  # the segment at position 2 reads set 1
        P._store(st, P._init_state(o, d, rng))
        live = np.zeros(n, bool)
        live[gen_lanes[(p, k)]] = True
        st["active"].copy_(torch.from_numpy(live))
        st["rays"].zero_()
        tr.bounce.fill_(2)
        tr.live.fill_(int(live.sum()))
        tr.widx[1] = p
        if full:
            tr._resorted(scene, 1, n, n, False, False)
        else:
            tr._segment(scene, 2, False)
            assert int(tr.widx[0]) == k
        return tr

    def by_pixel(tr):
        st = tr.bufs[0]
        pix = st["pix"]
        out = {k: torch.empty_like(st[k]).index_copy_(0, pix, st[k])
               for k in ("radiance", "active")}
        # the lanes still live lie in the width's prefix, where every
        # array was written
        at = st["active"].nonzero().squeeze(1)
        at = at[torch.argsort(pix[at])]
        for k in ("o", "d", "throughput", "last_pdf", "last_delta", "rng"):
            out[k] = st[k][at]
        out["live pix"] = pix[at]
        out["rays"], out["live"] = st["rays"].clone(), tr.live.clone()
        return out

    gen_lanes = {}
    for p in range(len(widths)):
        for k in range(p + 1):
            gen_lanes[(p, k)] = gen.choice(widths[p], widths[k],
                                           replace=False)
            assert P._prefix_width(n, widths[k]) == widths[k]
            got, want = by_pixel(run(p, k, False)), by_pixel(run(p, k, True))
            for key in want:
                assert torch.equal(got[key], want[key]), (p, k, key)
            assert 0 < int(got["live"]) <= widths[k]


def test_looped_resort_matches_reference(monkeypatch):
    """The looped form with the resort (32x32, 1 spp, max_bounces 1024,
    _SHRINK_MIN 64, so that its widths are 256, 512 and 1024) against the
    JAX package's looped render_spp of the flagship at the image bar;
    its deep segments run over n/4."""
    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator.path import PathConfig as JaxPathConfig
    from moonshine_tpu.render.camera import LensArrays as JaxLens
    from moonshine_tpu.render.renderer import render_spp as jax_render_spp

    monkeypatch.setattr(P, "_SHRINK_MIN", 64)
    js, jlens = _flagship_scene()
    want, want_rays = jax_render_spp(js, JaxLens.from_lens(jlens), 32, 32, 0,
                                     1, JaxPathConfig(**LOOPED))
    scene, lens = _flagship()
    taken = []
    resorted = P._Trace._resorted
    monkeypatch.setattr(P._Trace, "_resorted", lambda self, *a: (
        taken.append(a[3]) or resorted(self, *a)))
    stats = {}
    got, rays = RR.render_spp(scene, lens, 32, 32, 0, 1, PathConfig(**LOOPED),
                              stats=stats)
    assert stats["resort"] and stats["segments"] == len(taken) + 1
    assert min(taken) == 1024 // 4
    assert np.isfinite(got.numpy()).all()
    assert_image_close(got.numpy(), np.asarray(want))
    assert abs(int(rays) / float(want_rays) - 1.0) <= 1e-2
