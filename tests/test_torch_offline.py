"""The offline CLI end to end on the CPU: the Cornell glb and a small ZIP
skybox through moonshine_tpu's CLI and the port's, at the CLI's default
max_bounces (1024, so the bounce loop takes its looped form, which stops
when no lane is live). Image bar as in the other image tests: at least
99% of pixels within 1e-3 (absolute plus relative), means within 1e-3
relative."""

import numpy as np
import pytest

from moonshine_tpu.io.exr import read_exr as jax_read_exr
from moonshine_tpu.render import offline as JO
from moonshine_tpu_torch.io.exr import read_exr, write_exr
from moonshine_tpu_torch.render import offline as PO

from glb_builder import cornell_box_glb
from test_torch_render import assert_image_close

SIZE = ["--width", "48", "--height", "32", "--spp", "2"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("offline")
    (d / "cornell.glb").write_bytes(cornell_box_glb())
    yy, xx = np.mgrid[0:8, 0:16].astype(np.float32)
    sky = np.stack([0.2 + xx / 32, 0.3 + yy / 16, 0.25 + 0 * xx], -1)
    sky[1:3, 3:6] = 8.0  # a sun patch
    write_exr(d / "sky.exr", sky)
    return d


def test_cli_matches_reference(inputs, capsys):
    args = [str(inputs / "cornell.glb"), str(inputs / "sky.exr")]
    assert JO.main(args + [str(inputs / "jax.exr")] + SIZE) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    assert PO.main(args + [str(inputs / "port.exr")] + SIZE,
                   device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    phases = [ln.split(":")[0] for ln in lines]
    assert phases == [ln.split(":")[0] for ln in jax_lines] == [
        "load scene", "build device scene (BVH + atlas + envmap)",
        "render 2 spp (0.0 Mrays)", "write exr"]
    got = read_exr(inputs / "port.exr")
    want = jax_read_exr(inputs / "jax.exr")
    assert got.shape == (32, 48, 4) and np.isfinite(got).all()
    assert (got[..., 3] == 1.0).all()  # 3-channel file
    assert_image_close(got[..., :3], want[..., :3])
    assert got[..., :3].mean() > 0.01


def test_cli_defaults_and_device(inputs):
    args = PO.parse_args(["a.glb", "b.exr", "c.exr"])
    assert (args.spp, args.width, args.height, args.max_bounces,
            args.env_samples, args.mesh_samples) == (16, 1280, 720, 1024, 1, 1)
    import inspect

    assert inspect.signature(PO.main).parameters["device"].default == "cuda"
    assert args.mesh is None  # one device unless --mesh is given
    assert PO.parse_args(["a.glb", "b.exr", "c.exr", "--mesh",
                          "2,4"]).mesh == "2,4"
