"""Format-V traversal against the row kernels on the room scenes (port of
scripts/profile_vpacket.py, with profile_one.py's --count-visits).

    python -m moonshine_tpu_torch.scripts.profile_vpacket [--full]
        [--count-visits]

Builds room_184k (`room_scene(grid=6, subdivisions=4)`, the SAH 24-wide /
24-slot tree), and room_1M (grid=7, subdivisions=5) with --full, prints
the bytes of its rows and of its V tiles, and makes two 512x512 ray
states: the primary camera rays and the state after one bounce
(integrator/path.py `_init_state`, `_bounce_body`). On each it times the
four traversals the integrator would call on an HBM-class scene, through
the sorting `_hbm` wrappers: row closest, row any, V closest, V any,
with CUDA events around REPS calls on the same state (the reference
fed each call's output back into the next call's origins, which sent
closest-hit origins to ~1e28 after one call and timed empty frames; here
nothing is fed back). Then it prints the V/row ratios. --count-visits
prints the plain versions' visit counts for the same states.
"""

from __future__ import annotations

import argparse

import torch

from ..accel import packet, vpacket
from ..integrator import path as P
from ..render.camera import LensArrays
from ..render.renderer import _sample_rays
from ..scene.procedural import room_scene
from . import cuda_ms

T_MAX = 1e30
REPS = 10
SCENES = {"room_184k": (6, 4), "room_1M": (7, 5)}  # name: (grid, subdivisions)


def ray_states(scene, lens: LensArrays, size: int = 512):
    """(primary, bounce-1) lane states of a size x size frame, sample 0."""
    o, d, rng, _ = _sample_rays(lens, size, size, 0, True, scene.device)
    st0 = P._init_state(o, d, rng)
    st1 = P._bounce_body(scene, P.PathConfig(max_bounces=4), 0, dict(st0))
    return st0, st1


def variants(wbvh, vbvh) -> dict:
    """The four traversals, each a function of (o, d, active)."""
    return {
        "row closest": lambda o, d, a: packet.closest_hit_packet_hbm(
            wbvh, o, d, T_MAX, active_in=a),
        "row anyhit": lambda o, d, a: packet.any_hit_packet_hbm(
            wbvh, o, d, T_MAX, active_in=a),
        "V closest": lambda o, d, a: vpacket.closest_hit_vpacket_hbm(
            vbvh, o, d, T_MAX, active_in=a),
        "V anyhit": lambda o, d, a: vpacket.any_hit_vpacket_hbm(
            vbvh, o, d, T_MAX, active_in=a),
    }


def visit_counts(wbvh, vbvh, st) -> dict:
    """{(kernel, kind): packet.Visits} of the plain versions on a state."""
    args = (st["o"], st["d"], T_MAX, st["active"])
    out = {}
    for kernel, mod, tree in (("row", packet, wbvh), ("V", vpacket, vbvh)):
        out[(kernel, "closest")] = mod.closest_hit_plain(
            tree, *args, count_visits=True)[1]
        out[(kernel, "anyhit")] = mod.any_hit_plain(
            tree, *args, count_visits=True)[1]
    return out


def bench_scene(name: str, scene=None, lens=None,
                count_visits: bool = False) -> dict:
    """Times row and V traversal on the room scene `name` of SCENES (built
    here on the card unless given with its LensArrays); returns
    {(state, variant): ms}."""
    if scene is None:
        grid, sub = SCENES[name]
        world, lens_ = room_scene(grid=grid, subdivisions=sub)
        scene = world.build("cuda")
        lens = LensArrays.from_lens(lens_, "cuda")
    w = scene.wide
    v = vpacket.v_from_wide(w)
    print(f"\n=== {name}: tris={scene.num_tris} w={w.width} "
          f"cap={w.leaf_slots} nodes={w.num_nodes} leaves={w.num_leaves} | "
          f"rows {packet.row_bytes(w)} B, V {vpacket.tile_bytes(v)} B "
          f"(V vmem_fit={vpacket.fits_vmem(v)})", flush=True)
    states = dict(zip(("primary", "bounce1"), ray_states(scene, lens)))
    print(f"bounce-1 live lanes: {int(states['bounce1']['active'].sum())}",
          flush=True)
    out = {}
    for state_name, st in states.items():
        for vname, fn in variants(w, v).items():
            ms = cuda_ms(lambda: fn(st["o"], st["d"], st["active"]), REPS)
            out[(state_name, vname)] = ms
            print(f"{name} {state_name:8s} {vname:12s} {ms:9.4f} ms",
                  flush=True)
    for state_name in states:
        for kind in ("closest", "anyhit"):
            r = out[(state_name, f"row {kind}")]
            vv = out[(state_name, f"V {kind}")]
            print(f"{name} {state_name:8s} {kind}: V/row = {vv / r:.3f}x "
                  f"({'WIN' if vv < r else 'loss'})", flush=True)
    if count_visits:
        for state_name, st in states.items():
            for (kernel, kind), vis in visit_counts(w, v, st).items():
                print(f"{name} {state_name:8s} {kernel} {kind} visits: "
                      f"{vis.nodes + vis.leaves} ({vis.nodes} internal, "
                      f"{vis.leaves} leaf; {vis.node_rows} + "
                      f"{vis.leaf_rows} distinct records)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="add the 1M room")
    ap.add_argument("--count-visits", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_vpacket needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for name in ["room_184k"] + (["room_1M"] if args.full else []):
        bench_scene(name, count_visits=args.count_visits)


if __name__ == "__main__":
    main()
