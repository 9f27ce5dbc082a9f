"""The port's renderer end to end on the CPU: the flagship against
moonshine_tpu's render, the furnace against analytic truth, mirror_glass
against its committed golden, and the port's EXR reader against the
reference codec.

Image bar: at least 99% of pixels within 1e-3 (absolute plus relative)
and image means within 1e-3 relative. Not bitwise: the frameworks'
transcendentals differ in the last bits, and a ray grazing an edge or an
equal-t tie may send a few lanes down other paths."""

import pathlib

import numpy as np
import pytest
import torch

from moonshine_tpu_torch.integrator.path import PathConfig
from moonshine_tpu_torch.io.exr import read_exr
from moonshine_tpu_torch.render.camera import LensArrays
from moonshine_tpu_torch.render.renderer import render, render_spp
from moonshine_tpu_torch.scene import procedural

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "goldens"
FLAGSHIP_CFG = dict(max_bounces=4, env_samples_per_bounce=1,
                    mesh_samples_per_bounce=1)


def assert_image_close(img, ref):
    pix = (np.abs(img - ref) <= 1e-3 + 1e-3 * np.abs(ref)).all(axis=-1)
    assert pix.mean() >= 0.99, f"only {pix.mean():.4f} of pixels agree"
    assert abs(img.mean() / ref.mean() - 1.0) <= 1e-3


def _port_render(make, h, w, spp, cfg):
    world, lens = make()
    scene = world.build("cpu")
    img, rays = render_spp(scene, LensArrays.from_lens(lens, "cpu"), h, w, 0,
                           spp, cfg)
    return img.numpy() / spp, int(rays)


def test_flagship_matches_reference():
    """32x32, 1 spp, max_bounces=4: the JAX render (Pallas kernels in
    interpret mode) against the port's."""
    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator.path import PathConfig as JaxPathConfig
    from moonshine_tpu.render.camera import LensArrays as JaxLens
    from moonshine_tpu.render.renderer import render_spp as jax_render_spp

    js, jlens = _flagship_scene()
    want, want_rays = jax_render_spp(js, JaxLens.from_lens(jlens), 32, 32, 0,
                                     1, JaxPathConfig(**FLAGSHIP_CFG))
    got, rays = _port_render(procedural.flagship_scene, 32, 32, 1,
                             PathConfig(**FLAGSHIP_CFG))
    assert np.isfinite(got).all()
    assert_image_close(got, np.asarray(want))
    assert abs(rays / float(want_rays) - 1.0) <= 1e-2


def test_furnace_analytic():
    """Albedo-1 sphere in a unit sky: every pixel integrates to 1
    (tests/test_goldens.py's bar), through the looped bounce form."""
    img, _ = _port_render(
        procedural.furnace_scene, 64, 64, 8,
        PathConfig(max_bounces=8, env_samples_per_bounce=0,
                   mesh_samples_per_bounce=0, unroll=False))
    assert np.abs(img - 1.0).max() < 1e-5


def test_mirror_glass_matches_golden():
    img, _ = _port_render(
        procedural.mirror_glass_scene, 96, 96, 8,
        PathConfig(max_bounces=6, env_samples_per_bounce=1,
                   mesh_samples_per_bounce=0))
    gold = read_exr(GOLDEN_DIR / "mirror_glass.exr")[..., :3]
    assert_image_close(img, gold)


def test_unrolled_and_looped_forms_agree():
    """The unrolled form (all segments, thin last one) and the looped form
    (stops when no lane is live) give the same image; render() folds
    samples into the sensor's running mean."""
    world, lens = procedural.flagship_scene()
    scene = world.build("cpu")
    la = LensArrays.from_lens(lens, "cpu")
    base = dict(FLAGSHIP_CFG)
    a, ra = render_spp(scene, la, 16, 16, 3, 2, PathConfig(**base,
                                                          unroll=True))
    b, rb = render_spp(scene, la, 16, 16, 3, 2, PathConfig(**base,
                                                          unroll=False))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(ra) == int(rb) > 0
    sensor, total = render(scene, lens, 16, 16, 2, PathConfig(**base))
    ref, rays = render_spp(scene, la, 16, 16, 0, 2, PathConfig(**base))
    assert sensor.sample_count == 2 and total == int(rays)
    torch.testing.assert_close(sensor.image, ref / 2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["furnace", "cornell", "mirror_glass"])
def test_read_exr_matches_reference(name):
    from moonshine_tpu.io.exr import read_exr as reference_read_exr

    path = GOLDEN_DIR / f"{name}.exr"
    np.testing.assert_array_equal(read_exr(path), reference_read_exr(path))
