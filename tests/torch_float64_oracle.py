"""Which side of a port-vs-reference mismatch is farther from exact: the
port's float32 PBR terms and the JAX package's, each against the JAX
package's own formulas evaluated in float64 (its order of operations,
under `jax.enable_x64`), on the seeded lanes of two CPU tests:

- `test_torch_shading.py::test_bsdf[3]`: `eval_bsdf` of StandardPBR;
- `test_torch_shade.py::test_scatter_matches_reference[3]`: the
  scattered throughput, thr * f * |cos| / pdf at the sampled direction
  (the PCG draw is exact in float32; the sampling and the evaluation run
  in float64).

    PYTHONPATH=.:tests python tests/torch_float64_oracle.py

Put another checkout of the port first on PYTHONPATH to measure it.
Prints, for each case, the values that fail the tests' common bar (rtol
1e-5, atol 1e-6 for the BSDF, 1e-5 for the throughput), the port's and
the reference's relative error against float64 on those lanes, and the
largest error of each in float32 ulps of the exact value over every
lane; then one JSON line.
"""

from __future__ import annotations

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moonshine_tpu.bsdf import materials as JB
from moonshine_tpu.core import rng as JR
from moonshine_tpu_torch.bsdf import materials as PB
from moonshine_tpu_torch.core.frame import Frame as PFrame
from moonshine_tpu_torch.integrator import shade

import test_torch_shade
import test_torch_shading

PBR = JB.STANDARD_PBR


def _f64_material(fields):
    return JB.MaterialLanes(**{
        k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
        for k, v in fields.items()})


def _errors(port, ref, exact, bar):
    """On the values where port and ref differ past `bar`: how many,
    the largest relative error of each against exact, on how many the
    port is the farther, and by how many float32 ulps of the exact value
    at most. Over every value: the largest error of each in ulps."""
    port, ref = port.astype(np.float64), ref.astype(np.float64)
    failing = ~np.isclose(port, ref, **bar)
    scale = np.maximum(np.abs(exact), 1e-30)
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    ulp = np.maximum(ulp, np.finfo(np.float32).tiny)
    e_port, e_ref = np.abs(port - exact), np.abs(ref - exact)
    worse = ((e_port - e_ref) / ulp)[failing]
    return dict(
        values=int(port.size), failing=int(failing.sum()),
        port_max_rel=float((e_port / scale)[failing].max(initial=0.0)),
        ref_max_rel=float((e_ref / scale)[failing].max(initial=0.0)),
        port_farther=int((worse > 0).sum()),
        port_farther_max_ulps=float(worse.max(initial=0.0)),
        port_max_ulps=float((e_port / ulp).max()),
        ref_max_ulps=float((e_ref / ulp).max()))


def bsdf() -> dict:
    fields, w_i, w_o, _ = test_torch_shading.bsdf_case(PBR)
    P = torch.from_numpy
    port = PB.eval_bsdf(PB.MaterialLanes(**{k: P(v) for k, v in
                                            fields.items()}),
                        P(w_i), P(w_o)).numpy()
    jm = JB.MaterialLanes(**{k: jnp.asarray(v) for k, v in fields.items()})
    ref = np.asarray(JB.eval_bsdf(jm, jnp.asarray(w_i), jnp.asarray(w_o)))
    with jax.enable_x64(True):
        exact = np.asarray(JB.eval_bsdf(
            _f64_material(fields), jnp.asarray(w_i.astype(np.float64)),
            jnp.asarray(w_o.astype(np.float64))))
    return _errors(port, ref, exact, test_torch_shading.TOL)


def scatter() -> dict:
    fields, (nrm, s, t), wo, _, state = test_torch_shade.scatter_case(PBR)
    P = torch.from_numpy
    surf = shade.Surface(
        position=P(state["position"]), tri_n=P(state["tri_n"]),
        frame=PFrame(n=P(nrm), s=P(s), t=P(t)), w_o_ss=P(wo),
        mat=PB.MaterialLanes(**{k: P(v) for k, v in fields.items()}),
        radiance=P(state["rad"]), active=P(state["active"]))
    # the throughput does not depend on the light samples: none is
    # weighted (an earlier port takes them as a list, and no state)
    earlier = "state" not in inspect.signature(
        shade.scatter_plain).parameters
    got = shade.scatter_plain(
        surf, P(state["o"]), P(state["d"]), P(state["thr"]), surf.radiance,
        P(state["rng"].astype(np.int64)), surf.active,
        *([[]] if earlier else [None, {}]))
    want = test_torch_shade._ref_scatter(
        JB.MaterialLanes(**{k: jnp.asarray(v) for k, v in fields.items()}),
        test_torch_shade.JFrame(n=jnp.asarray(nrm), s=jnp.asarray(s),
                                t=jnp.asarray(t)),
        jnp.asarray(wo), jnp.asarray(state["position"]),
        jnp.asarray(state["tri_n"]), jnp.asarray(state["o"]),
        jnp.asarray(state["d"]), jnp.asarray(state["thr"]),
        jnp.asarray(state["rad"]), jnp.asarray(state["rng"]),
        jnp.asarray(state["active"]), [])
    _, r2 = JR.next_float2(jnp.asarray(state["rng"]))
    with jax.enable_x64(True):
        mat = _f64_material(fields)
        wo64 = jnp.asarray(wo.astype(np.float64))
        w_i, pdf = JB.sample_bsdf(mat, wo64,
                                  jnp.asarray(np.asarray(r2), jnp.float64))
        f = JB.eval_bsdf(mat, w_i, wo64)
        mul = np.asarray(f * (jnp.abs(w_i[..., 2])
                              / jnp.maximum(pdf, 1e-30))[..., None])
    lanes = (got["active"].numpy() & np.asarray(want["active"])
             & (np.asarray(pdf) > 0.0))
    exact = state["thr"].astype(np.float64) * mul
    return _errors(got["throughput"].numpy()[lanes],
                   np.asarray(want["throughput"])[lanes], exact[lanes],
                   test_torch_shade.TOL)


def main() -> None:
    result = {"bsdf[3]": bsdf(), "scatter[3]": scatter()}
    for case, r in result.items():
        print(f"{case}: {r['failing']} of {r['values']} values past the "
              f"bar; on them the largest relative error {r['port_max_rel']:.3g}"
              f" (port), {r['ref_max_rel']:.3g} (reference), the port the "
              f"farther on {r['port_farther']}, by at most "
              f"{r['port_farther_max_ulps']:.1f} ulps; over every value the "
              f"largest error {r['port_max_ulps']:.1f} ulps (port), "
              f"{r['ref_max_ulps']:.1f} (reference)")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
