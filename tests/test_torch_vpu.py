"""The port's arithmetic microbenchmarks (moonshine_tpu_torch/scripts/
profile_vpu.py) against scripts/profile_vpu.py's Pallas kernels, run in
TPU interpret mode on the CPU with VISITS = 20, for every configuration
its main() runs.

Tolerances: the slab count is an int32 and must be equal. The ALU chain
on the reference's inputs (1.0 and 0.5) stays exact in both dtypes and is
compared bit for bit; on seeded inputs bfloat16 is bit-equal, while in
float32 XLA's CPU backend contracts `a * b + a` and `a * b + b` into fused
multiply-adds, which the port's per-op rounding does not (measured: 1
ulp on some lanes), so float32 is held to 1e-6 relative there."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from moonshine_tpu_torch.accel import native
from moonshine_tpu_torch.scripts import profile_vpu as PV

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
import profile_vpu as JV  # noqa: E402

VISITS = 20
_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JV, "VISITS", VISITS)
    with pltpu.force_tpu_interpret_mode():
        yield


class _SeededJnp:
    """jnp for the reference's run(), whose two jnp.full calls return the
    given arrays instead."""

    def __init__(self, *arrays):
        self._arrays = list(arrays)

    def full(self, shape, fill_value, dtype):
        return jnp.asarray(self._arrays.pop(0), dtype).reshape(shape)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("config", PV.SLAB_CONFIGS, ids=lambda c: c[0])
def test_slab_matches_reference(interpret, config):
    name, dt, fma_form, packed = config
    want = np.asarray(JV._mk_slab(_JAX_DTYPE[dt], fma_form, packed)())
    got = PV.slab(*PV.slab_inputs(dt, "cpu"), fma_form, packed, VISITS)
    assert got.dtype == torch.int32
    assert int(got) == int(want[0, 0]) == 0  # no lane hits at these inputs


@pytest.mark.parametrize("config", PV.ALU_CONFIGS, ids=lambda c: c[0])
@pytest.mark.parametrize("seed", [None, 5])
def test_alu_matches_reference(interpret, monkeypatch, config, seed):
    name, dt, rows = config
    a, b = PV.alu_inputs(dt, rows, "cpu", seed=seed)
    if seed is not None:
        monkeypatch.setattr(JV, "jnp", _SeededJnp(a.float().numpy(),
                                                  b.float().numpy()))
    want = np.asarray(JV._mk_alu(_JAX_DTYPE[dt], rows=rows)()
                      .astype(jnp.float32))[0]
    got = PV.alu(a, b, VISITS)
    assert got.dtype == dt and got.shape == (rows, 128)
    got = got.float().numpy()
    if dt == torch.float32 and seed is not None:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _numpy_slab(rows, planes, fma_form, packed, visits):
    """The slab count in float32 numpy, child by child."""
    f = np.float32
    o = [p.numpy().reshape(-1) for p in planes[:3]]
    inv = [p.numpy().reshape(-1) for p in planes[3:]]
    oinv = [o[c] * inv[c] for c in range(3)]
    rows = rows.numpy()
    total = 0
    for v in range(visits):
        word = np.zeros(o[0].shape, np.int64)
        for j in range(8):
            lo = [rows[v % 128, c * 8 + j] for c in range(3)]
            hi = [rows[v % 128, 24 + c * 8 + j] for c in range(3)]
            if fma_form:
                t0 = [lo[c] * inv[c] - oinv[c] for c in range(3)]
                t1 = [hi[c] * inv[c] - oinv[c] for c in range(3)]
            else:
                t0 = [(lo[c] - o[c]) * inv[c] for c in range(3)]
                t1 = [(hi[c] - o[c]) * inv[c] for c in range(3)]
            tnear = np.max([np.minimum(t0[c], t1[c]) for c in range(3)], 0)
            tfar = np.min([np.maximum(t0[c], t1[c]) for c in range(3)], 0)
            hit = ((tnear <= tfar) & (tfar >= f(0))
                   & (tnear <= np.finfo(f).max))
            word |= hit.astype(np.int64) << j
            total += 0 if packed else int(hit.any())
        total += int(word.max()) if packed else 0
    return total


@pytest.mark.parametrize("fma_form,packed", [(False, False), (True, False),
                                             (False, True)])
def test_slab_counts_hits(fma_form, packed):
    """On seeded inputs where lanes hit some children, the float32 count
    equals a direct numpy count, and bfloat16 lies near it."""
    rows, planes = PV.slab_inputs(torch.float32, "cpu", seed=1)
    got = int(PV.slab(rows, planes, fma_form, packed, VISITS))
    assert got == _numpy_slab(rows, planes, fma_form, packed, VISITS)
    cap = VISITS * (255 if packed else 8)
    assert 0 < got < cap
    rows, planes = PV.slab_inputs(torch.bfloat16, "cpu", seed=1)
    got_bf16 = int(PV.slab(rows, planes, fma_form, packed, VISITS))
    assert abs(got_bf16 - got) <= 0.05 * got


@pytest.mark.parametrize("fma_form,packed", [(False, False), (True, False),
                                             (False, True)])
def test_slab_plain_past_the_wrap(fma_form, packed):
    """Past row 127 the visits wrap to row 0 (130 visits: rows 0-127, then
    0 and 1 again): the plain version's float32 count equals a direct
    numpy count, and exceeds its count at 128 visits by what visits 0-1
    count."""
    rows, planes = PV.slab_inputs(torch.float32, "cpu", seed=PV.SEED)
    got = int(PV.slab_plain(rows, planes, fma_form, packed, 130))
    assert got == _numpy_slab(rows, planes, fma_form, packed, 130)
    assert got == (int(PV.slab_plain(rows, planes, fma_form, packed, 128))
                   + int(PV.slab_plain(rows, planes, fma_form, packed, 2)))


def test_chain_floor_counts_the_critical_path():
    """Ten dependent operations an iteration: at 4 cycles each and 1 GHz,
    2000 iterations take 0.08 ms; the slower of mul and add sets the two
    steps that take both in parallel."""
    lat = dict(mul=4.0, add=4.0, min=4.0, max=4.0)
    assert PV.chain_floor_ms(lat, 1e9) == pytest.approx(0.08)
    lat = dict(mul=6.0, add=4.0, min=2.0, max=3.0)
    per_iter = 2 * 6 + 2 * 4 + 2 * 6 + 2 * 2 + 2 * 3
    assert PV.chain_floor_ms(lat, 2e9, 10) == pytest.approx(
        10 * per_iter / 2e9 * 1e3)


def test_ptxas_summary():
    """The --against scripts' build report: kernels, registers and spills
    from ptxas -v's lines; a library loaded from an earlier build has
    none."""
    log = ("ptxas info    : Function properties for _Z4slab\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\nptxas info    : Used 40 registers, used 1 barriers\n"
           "ptxas info    : Function properties for _Z3alu\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 128 registers\n")
    assert native.ptxas_summary(log) == ("2 kernels, 40-128 registers, 8 "
                                         "bytes of spill stores")
    assert native.ptxas_summary("") == "no ptxas report (built earlier)"


def test_against_builds_nothing_for_an_identical_checkout(capsys):
    """A checkout whose sources and headers equal this one's starts no
    nvcc (none is needed to ask), and says so for each source."""
    root = pathlib.Path(native.__file__).resolve().parents[2]
    native.build_against([root], ("vpu", "treelet"))
    said = capsys.readouterr().out
    assert "vpu.cu and its headers equal" in said
    assert "treelet.cu and its headers equal" in said


def test_probes_and_entry_point_need_the_card():
    """The probes run on a CUDA device only; profile_vpu's entry point
    raises without one (with or without --against)."""
    with pytest.raises(ValueError, match="CUDA device"):
        PV.latency("f32", "mul", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        PV.empty_ms("cpu")
    if not torch.cuda.is_available():
        for argv in ([], ["--against", "elsewhere"]):
            with pytest.raises(RuntimeError, match="needs a CUDA device"):
                PV.main(argv)


def test_wrappers_reject_bad_input():
    rows, planes = PV.slab_inputs(torch.float32, "cpu")
    with pytest.raises(ValueError):
        PV.slab(rows.double(), planes, False, False, 2)
    with pytest.raises(ValueError):
        PV.slab(rows, planes[:5] + [planes[5].bfloat16()], False, False, 2)
    a, b = PV.alu_inputs(torch.float32, device="cpu")
    with pytest.raises(ValueError):
        PV.alu(a, b.bfloat16(), 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        PV.alu(a.to("meta"), b.to("meta"), 2)
