"""The quantised-row decode probe (TPU kernel 8, scripts/probe_bitcast.py)
against the port's plain version, bit for bit.

The JAX side runs the reference's own kernel body
(`probe_bitcast.make_kernel`) under a pallas_call with the reference's
specs in interpret mode, on the reference's rows and on seeded random
int32 rows, at all six row widths."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from moonshine_tpu_torch.scripts import probe_bitcast as P

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
import probe_bitcast as J  # noqa: E402


def jax_decode(rows: np.ndarray) -> np.ndarray:
    rowlen = rows.shape[1]
    out = pl.pallas_call(
        J.make_kernel(rowlen),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((4, 128), jnp.float32),
        scratch_shapes=[
            pltpu.SMEM((rowlen,), jnp.int32),
            pltpu.SMEM((8,), jnp.float32),
            pltpu.SemaphoreType.DMA,
        ],
        interpret=True,
    )(jnp.asarray(rows))
    return np.asarray(out)


@pytest.mark.parametrize("rowlen", P.ROWLENS)
def test_plain_matches_reference_kernel(rowlen):
    for rows in (P.reference_rows(rowlen, "cpu"),
                 P.seeded_rows(rowlen, seed=rowlen, device="cpu")):
        want = jax_decode(rows.numpy())
        got = P.decode_rows_plain(rows).numpy()
        assert got.dtype == np.float32 and got.shape == (4, 128)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # seeded rows reach the rounding conversions (|word| > 2^24)
    assert np.abs(rows.numpy()[1, [0, -1]]).min() > 2 ** 24


def test_reference_values():
    out = P.decode_rows(P.reference_rows(64, "cpu")).numpy()
    np.testing.assert_array_equal(
        out[:, 0], np.float32([-3.25, 3.375, 8194.375, 1234567.0]))


def test_run_and_main_pass_on_cpu(capsys):
    assert P.run(40, "cpu")
    assert P.main(device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "overall: PASS"
    assert sum("PASS" in ln for ln in lines) == len(P.ROWLENS) + 2
    assert P.LAUNCHES["bitcast"] == 0  # the plain version never counts


def test_wrapper_rejects_bad_input():
    rows = P.reference_rows(40, "cpu")
    for bad in (rows.float(), rows[:3], rows[:, :1], rows.t().contiguous(),
                rows.repeat(1, 2)[:, ::2]):
        with pytest.raises(ValueError):
            P.decode_rows(bad)
    with pytest.raises(ValueError, match="no kernel"):
        P.decode_rows(rows.to("meta"))
