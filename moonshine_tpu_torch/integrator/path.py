"""Unidirectional path tracer with NEE + MIS, batched over rays (port of
moonshine_tpu/integrator/path.py; parity: PathTracingIntegrator,
shaders/hrtsystem/integrator.hlsl:55-184).

Every lane advances in lockstep with masks: each bounce issues one batched
closest hit, decodes the surface, draws the NEE light samples, traces all
shadow rays as one batched any hit, weights them with the power
heuristic, and scatters. Emissive, termination, NEE and miss handling
follow the reference in order; per-lane RNG consumption is identical in
the unrolled and the looped form, so both give the same image.

Traversal dispatch follows the reference (`_hbm_mode`): the packet
kernel for scenes whose rows fit the reference's VMEM budget, the
treelet-scheduled kernel beyond it when `MSN_TREELETS=1` and the tree is
8-wide with 8-slot leaves, else the packet kernel on coherence-sorted
rays; where the reference falls back to its per-lane jnp walk (no wide
tree, or an HBM-class tree whose stack bound exceeds the HBM limit), the
per-lane walk of accel/traverse.py over the binary BVH ("lanes"). A
two-level scene (accel/tlas.py, past the flatten cap) goes to the
two-level walk before any of these; its hits carry the instance, whose
transform the decode applies to the object-space rows (`_inst_world`),
and it takes no resort (it has no wide tree to key one on). Each
wrapper launches its CUDA kernel for CUDA tensors. The
per-bounce coherence resort (`_resort_state`) reorders the whole lane
state, and `_bounce_shrunk` then runs a bounce over the live prefix only;
both move lanes, never change a lane's result, and radiance returns to
pixel order at the end. `trace_paths_staged` is the reference's staged
API for very large frames (renderer.MAX_LANES).

The loop (`_Trace`) keeps its state in static buffers and runs as steps
of graphs.Steps: on a CUDA device graph replays, on the CPU (and inside
graphs.eager()) the same functions eagerly. What the reference decides
on the device stays there (graphs.choose / loop: conditional nodes of
the graphs): the live prefix's width and the looped form's stop. The
unrolled form reads nothing on the host; the looped form reads the live
count once a block of LOOP_BLOCK segments.

A segment's shading is integrator/shade.py: the env miss; the surface
decode with the termination and every NEE light draw, which writes the
shadow batch; the light weighting with the BSDF scatter. Each is a
kernel of csrc/shade.cu on the card (working in place on the lane
state), the plain torch version on the CPU. The resort's key, its sort
and the move of every lane array are core/sortutil.py's (kernels of
csrc/sort.cu on the card).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..accel import packet, tlas as tlas_mod, traverse, treelet
from ..core import sortutil
from ..core.mathutil import INF_T
from . import graphs, shade


@dataclass(frozen=True)
class PathConfig:
    """Render knobs (the reference's specialisation constants)."""

    max_bounces: int = 4
    env_samples_per_bounce: int = 1
    mesh_samples_per_bounce: int = 1
    # None = auto: the unrolled form when max_bounces + 2 <= 10
    unroll: bool | None = None
    # re-sort the whole lane state by ray coherence once per bounce (and
    # run deep bounces over the live prefix); the image is unchanged.
    # None = auto (_resolve_resort): on for HBM-class scenes up to 600k
    # lanes, on for VMEM-class scenes that hold a mirror or glass
    resort_bounces: bool | None = None


# Opt-in treelet-scheduled traversal for HBM-class scenes (the reference's
# MSN_TREELETS=1, read at each dispatch here).
def _use_treelets() -> bool:
    return os.environ.get("MSN_TREELETS", "0") == "1"


# Re-sort the NEE shadow batch on delta-carrying scenes even when the state
# is resorted (the reference's opt-in MSN_SHADOW_COMPACT=1, read at each
# bounce here); the image is unchanged.
def _shadow_compact() -> bool:
    return os.environ.get("MSN_SHADOW_COMPACT", "0") == "1"


def _hbm_mode(wide) -> str:
    """'vmem' | 'treelet' | 'hbm' | 'lanes', as the reference picks them
    ('lanes' is its 'jnp': the per-lane walk of the binary BVH, taken
    when there is no wide tree or an HBM-class tree's stack bound exceeds
    the HBM limit)."""
    if wide is None:
        return "lanes"
    if packet.fits_vmem(wide) and packet.stack_ok(wide, hbm=False):
        return "vmem"
    if not packet.stack_ok(wide, hbm=True):
        return "lanes"
    if _use_treelets() and treelet.available(wide):
        return "treelet"
    return "hbm"


def _binary(scene):
    """(bvh, tri_verts_sorted) of the fallback walk."""
    if scene.bvh is None or scene.tri_verts_sorted is None:
        raise ValueError("the scene needs the per-lane fallback walk but "
                         "carries no binary BVH (scene_from_arrays without "
                         "bvh.* arrays)")
    return scene.bvh, scene.tri_verts_sorted


def _closest(scene, o, d, t_max, active, presorted: bool = False):
    """Closest-hit dispatch; presorted=True (the per-bounce state resort)
    skips the HBM wrapper's own sort."""
    tl = getattr(scene, "tlas", None)  # callers may pass a bare namespace
    if tl is not None:
        return tlas_mod.closest_hit_tlas(tl, o, d, t_max, active_in=active)
    wide = scene.wide
    mode = _hbm_mode(wide)
    if mode == "vmem":
        return packet.closest_hit_packet(wide, o, d, t_max, active_in=active)
    if mode == "treelet":
        return treelet.closest_hit_treelet(wide, o, d, t_max,
                                           active_in=active)
    if mode == "hbm":
        return packet.closest_hit_packet_hbm(wide, o, d, t_max,
                                             active_in=active,
                                             sort=not presorted)
    return traverse.closest_hit(*_binary(scene), o, d, t_max,
                                active_in=active)


def _any_hit(scene, o, d, t_max, active, presorted: bool = False):
    tl = getattr(scene, "tlas", None)
    if tl is not None:
        return tlas_mod.any_hit_tlas(tl, o, d, t_max, active_in=active)
    wide = scene.wide
    mode = _hbm_mode(wide)
    if mode == "vmem":
        return packet.any_hit_packet(wide, o, d, t_max, active_in=active)
    if mode == "treelet":
        return treelet.any_hit_treelet(wide, o, d, t_max, active_in=active)
    if mode == "hbm":
        return packet.any_hit_packet_hbm(wide, o, d, t_max,
                                         active_in=active,
                                         sort=not presorted)
    return traverse.any_hit(*_binary(scene), o, d, t_max, active_in=active)


def _resolve_resort(scene, cfg: PathConfig, n_lanes: int | None = None
                    ) -> bool:
    """The reference's resort choice: as configured, else on for
    HBM-class scenes (trace_paths: up to 600k lanes, which render_sample
    and render exceed for frames above that; n_lanes=None, the staged
    path: at any lane count) and for VMEM-class ones holding a mirror or
    glass; treelet scenes sort inside each dispatch instead, and the
    per-lane walk ('lanes') takes no resort. A scene without a wide tree
    (a two-level one) takes none even when configured: its key is the
    tree's bounds, and the reference's resort of such a scene moves no
    lane."""
    if scene.wide is None:
        return False
    if cfg.resort_bounces is not None:
        return cfg.resort_bounces
    mode = _hbm_mode(scene.wide)
    if mode == "hbm":
        return n_lanes is None or n_lanes <= 600_000
    return mode == "vmem" and scene.has_delta


# the profiler ranges a sample opens around its stages, in order
# (render/profile_frame.py splits a sample's kernel time by them): the
# camera rays (render/renderer.py), a bounce's stages (a path draws its
# light samples inside "surface", the direct integrator in "nee_draw"),
# the copy of a bounce's outputs into the state's buffers (`_store`), the
# resort with its moves, the ray and live counts, and the sample's
# accumulation (renderer.py)
STAGES = ("camera", "traversal", "env", "surface", "nee_draw", "any_hit",
          "scatter", "store", "resort", "live_count", "accumulate")


def _bounce_body(scene, cfg: PathConfig, bounce, st: dict,
                 last: bool = False, resort: bool = False,
                 roulette: bool | None = None, live=None) -> dict:
    """One bounce over the whole lane batch. `bounce` is an int or a
    device scalar (the graphed loop's, so that one graph serves many
    bounces); `roulette` is whether bounce > 3, the one branch on it taken
    on the host (by default read from an int bounce). last=True marks the
    final segment of the unrolled form, where every lane dies after the
    emissive/miss accumulation, so NEE, roulette and scatter are skipped.
    resort=True: the state is coherence-sorted, so traversal skips its
    own sort. Each stage runs inside a profiler range (STAGES); the
    miss, the surface decode with the light draw, and the scatter are
    kernels of csrc/shade.cu (integrator/shade.py), which on the card
    update the state's radiance, throughput, rng, o, d and masks in
    place.

    The counts (the reference's jnp.sum at path.py:400, :580, :687):
    `live` is an int64 device scalar holding the lanes live at the
    segment's start (the trace's; None, a state run by hand: summed here
    from its mask). The segment traces those lanes, so st["rays"] (in
    place) gains `live`; then `live` is zeroed and recounted by the
    kernels that write the masks: the surface adds the shadow rays it
    sets to st["rays"], the scatter the lanes it leaves live to `live`;
    the last segment leaves none."""
    if roulette is None:
        roulette = bounce > 3
    active = st["active"]
    o, d = st["o"], st["d"]
    throughput = st["throughput"]
    last_pdf = st["last_pdf"]
    last_delta = st["last_delta"]
    rng = st["rng"]
    if live is None:
        live = active.sum()
    with record_function("live_count"):
        rays = st["rays"]
        rays += live
        live.zero_()

    with record_function("traversal"):
        hit = _closest(scene, o, d, INF_T, active, presorted=resort)
    # ---- miss: environment radiance (integrator.hlsl:166-180), into the
    # state's radiance on the card
    with record_function("env"):
        # the lanes that missed add the env radiance and leave: active
        # becomes the reference's active & is_hit (on the card in place on
        # the state's radiance and mask; nothing reads the mask of before)
        radiance, active = shade.env_miss(
            scene.env, cfg.env_samples_per_bounce, bounce, d, active,
            hit.tri, throughput, st["radiance"], last_pdf, last_delta)

    # ---- decode the surface and add its emission (integrator.hlsl:93-124);
    # then the termination and the NEE draws (:126-151)
    with record_function("surface"):
        draw = None if last else shade.DrawIn(
            scene.env, cfg.env_samples_per_bounce, cfg.max_bounces, roulette,
            rng)
        surf = shade.surface(scene, cfg.mesh_samples_per_bounce, bounce, hit,
                             o, d, active, throughput, radiance, last_pdf,
                             last_delta, shade.THIN if last else shade.FULL,
                             draw, rays=rays)
    if last:
        # the max-bounce cut kills every lane here
        return dict(st, active=surf.active, radiance=surf.radiance,
                    rays=rays)

    lights = surf.lights
    if surf.shadow is not None:
        with record_function("any_hit"):
            # shadow rays inherit the (possibly resorted) lane order
            occluded = _any_hit(
                scene, *surf.shadow,
                presorted=resort and not (_shadow_compact()
                                          and scene.has_delta),
            )
        lights = lights._replace(occluded=occluded.view(lights.lane.shape))

    # ---- weight the light samples and scatter (integrator.hlsl:139-163)
    with record_function("scatter"):
        out = shade.scatter(surf, o, d, surf.throughput, surf.radiance,
                            surf.rng, surf.active, lights, state=st,
                            live=live)
    return dict(st, **out, rays=rays)


# the resort key's cells a side (8^3 cells x 8 octants) and bits
RESORT_CELLS = 8
RESORT_BITS = sortutil.key_bits(RESORT_CELLS)
# the lane arrays a dead lane still needs behind the live prefix: radiance
# and pix (the trace's radiance in pixel order), active (the live count,
# the next key) and rng (trace_paths returns it)
_TAIL = ("active", "radiance", "rng", "pix")


def _resort_state(scene, st: dict, out: dict | None = None,
                  prefix: int | None = None,
                  width: int | None = None) -> dict:
    """Reorder every lane array of the state by ray coherence (8^3
    origin cells x direction octant, dead lanes keyed 1 << 20 so they
    form the tail) with one stable sort that moves them all
    (core/sortutil.py: kernels on the card). Lanes keep their RNG
    streams and pixel ids. A scene without a wide tree keeps the state as
    it is.

    With `out` (the loop's other buffers) the sorted state goes there and
    is returned: only the first `prefix` lanes are sorted (every lane
    past them is dead, keyed 1 << 20 at the last resort, so a stable sort
    of the whole state leaves them where they lie), and of those only
    the first `width` (the next bounce's lanes, every live one among
    them) are written for each array but the tail's (`_TAIL`), which is
    written whole."""
    if scene.wide is None:
        return st
    n = st["pix"].shape[0]
    prefix = n if prefix is None else prefix
    names = [k for k, v in st.items() if _is_lane(v, n)]
    key = sortutil.KeyIn(st["o"][:prefix], st["d"][:prefix],
                         scene.wide.bounds, RESORT_CELLS,
                         st["active"][:prefix])
    rows = None
    if out is not None and width is not None:
        rows = [n if k in _TAIL else width for k in names]
    _, moved = sortutil.sort_lanes(
        key, [st[k] for k in names], RESORT_BITS,
        out=None if out is None else [out[k] for k in names], rows=rows)
    return {**(st if out is None else out), **dict(zip(names, moved))}


def _is_lane(v, n: int) -> bool:
    return torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == n


_SHRINK_MIN = 4 * 1024  # lanes below which the live prefix is not worth it


def _prefix_width(n: int, live: int) -> int:
    """The lanes a resorted bounce runs over: a quarter or a half of the n
    lanes when the live count fits, else all (all below _SHRINK_MIN)."""
    if n < _SHRINK_MIN:
        return n
    return n // 4 if live <= n // 4 else (n // 2 if live <= n // 2 else n)


def _widths(n: int) -> tuple:
    """The live prefix's widths for n lanes, by index: n/4, n/2, n."""
    return n // 4, n // 2, n


def _width_index(live, bounds, out=None):
    """`_prefix_width`'s choice on the device: the index into _widths(n)
    of the live count `live` (a 0-d int64 tensor), with `bounds` the
    int64 tensor [n // 4, n // 2] (n >= _SHRINK_MIN); into `out`, a 0-d
    int64 tensor, if given."""
    return torch.bucketize(live, bounds, out=out)


def _store(dst: dict, src: dict) -> None:
    """Copy src's values into dst's tensors in place (skipping any that
    already is dst's): a step leaves its results in static buffers."""
    for k, v in src.items():
        if v is not dst[k]:
            dst[k].copy_(v)


def _bounce_shrunk(scene, cfg: PathConfig, bounce, st: dict, last: bool,
                   width: int, roulette: bool = False, live=None) -> dict:
    """A bounce over the first `width` lanes of a resorted state (live
    lanes first; `_prefix_width` of the live count), written into that
    prefix of `st` in place. Dead lanes' state is final, so the image is
    unchanged; their RNG stops advancing, which nothing observes. Every
    live lane lies in the prefix, so its counts are the state's."""
    n = st["o"].shape[0]
    head = {k: (v[:width] if _is_lane(v, n) else v) for k, v in st.items()}
    out = _bounce_body(scene, cfg, bounce, head, last=last, resort=True,
                       roulette=roulette, live=live)
    with record_function("store"):
        _store(head, out)
    return st


def _init_state(ray_o, ray_d, rng_state) -> dict:
    """A fresh lane state for these camera rays (what _Trace.reset makes
    in its static buffers)."""
    N = ray_o.shape[0]
    dev = ray_o.device
    f32 = torch.float32
    return dict(
        active=torch.ones(N, dtype=torch.bool, device=dev),
        o=ray_o,
        d=ray_d,
        throughput=torch.ones((N, 3), dtype=f32, device=dev),
        radiance=torch.zeros((N, 3), dtype=f32, device=dev),
        last_pdf=torch.ones(N, dtype=f32, device=dev),
        last_delta=torch.zeros(N, dtype=torch.bool, device=dev),
        rng=rng_state,
        rays=torch.zeros((), dtype=torch.int64, device=dev),
        pix=torch.arange(N, dtype=torch.int64, device=dev),
    )


# the looped form's segments a block: a block is one replay, after which
# the host reads the live count once to decide whether to replay the
# next; each segment of a block runs under the reference's while_loop
# cond on the device, so a block that overruns the stop runs no more
# segments. Even and >= 4, so every block after the first has the same
# roulette and buffer sets at each position (one graph replays for all).
# 16 by measurement (scripts/compare_loop.py --blocks on an H100 80GB
# HBM3 at 700 W, PERF.md §6): offline_720p ran the same at 8, 16 and 32,
# engine_720p fastest at 16; a skipped guard costs ~5 us of the card's
# time, a read ~29 us of the host's.
LOOP_BLOCK = 16


class _Trace:
    """The bounce loop of one run shape (scene, lane count, cfg and form)
    over static state: the lane arrays, the device bounce index (the
    segments run), the live count and the segments' widths. With
    `resort` the lane arrays have two sets of buffers, `bufs`: a resorted
    segment moves the state from one set into the other
    (`_resort_state` with out=) and runs there, so no copy goes back; the
    segment at position p > 0 reads set (p - 1) % 2, so the set that
    holds the state after S segments is (S - 1) % 2 (`with_state`).

    The segment's choices follow the reference's device-side control: a
    resorted segment's width (`_prefix_width` of the live count, its
    nested lax.cond) and the prefix it sorts (the last segment's width)
    are chosen on the device among the (prefix, width) pairs with width <=
    prefix (`graphs.choose`, one SWITCH node); the looped form runs each
    segment after the first under the while_loop's cond, live > 0 and
    bounce < max_bounces + 2 (`graphs.loop`: a block's first guard is set
    by a set kernel, each later one by the tail of the segment before it,
    which also counts that segment). The
    unrolled form is one step and reads nothing on the host. The looped
    form runs blocks of LOOP_BLOCK segments, one step each, and reads the
    live count once after a block: `run` enqueues its copy to the host,
    yields this trace, and the caller sends back `live_count()`
    (`run_alone` does so at once; parallel/sharding.py first enqueues
    every other shard's block)."""

    def __init__(self, n: int, device, cfg: PathConfig, resort: bool,
                 unroll: bool, sort_first: bool, capture: bool):
        self.cfg, self.resort, self.n = cfg, resort, n
        self.unroll, self.sort_first = unroll, sort_first
        self.n_segments = cfg.max_bounces + 2
        rays = torch.empty((n, 3), dtype=torch.float32, device=device)
        st = _init_state(rays, torch.empty_like(rays),
                         torch.empty(n, dtype=torch.int64, device=device))
        # the camera rays' set first; the second shares the ray count
        self.bufs = [st] + ([{k: (v if k == "rays" else torch.empty_like(v))
                              for k, v in st.items()}] if resort else [])
        self.bounce = torch.empty((), dtype=torch.int64, device=device)
        # the lanes live after the last segment (n after reset), recounted
        # by each segment's kernels (_bounce_body)
        self.live = torch.empty_like(self.bounce)
        # the index into _widths(n) of each segment's width, by the
        # parity of its position (a segment's prefix is the last one's),
        # and the live counts that bound the choice
        self.widx = torch.empty(2, dtype=torch.int64, device=device)
        self.bounds = torch.tensor([n // 4, n // 2], dtype=torch.int64,
                                   device=device)
        # the live count on the host: on a card a pinned copy, made
        # without blocking, and an event that says when it has landed
        self._live_host, self._landed = self.live, None
        if self.live.device.type == "cuda":
            self._live_host = torch.empty((), dtype=torch.int64,
                                          pin_memory=True)
            self._landed = torch.cuda.Event()
        self.steps = graphs.Steps(device, capture)
        self.out = None  # trace_paths' radiance and rng (_trace_rays)
        # held by a caller from loading the buffers to reading them
        self.lock = threading.Lock()

    def reset(self) -> None:
        """The state of fresh camera rays, whose o, d and rng the caller
        wrote into the first set, `bufs[0]` (a step's work; on the card a
        frame's camera rays write all of it in one kernel,
        render/frame_kernels.py)."""
        st = self.bufs[0]
        st["active"].fill_(True)
        st["throughput"].fill_(1.0)
        st["radiance"].zero_()
        st["last_pdf"].fill_(1.0)
        st["last_delta"].zero_()
        st["rays"].zero_()
        torch.arange(self.n, out=st["pix"])
        self.bounce.zero_()
        self.widx.fill_(2)  # the first segment runs over every lane
        self.live.fill_(self.n)

    def run(self, scene):
        """The segments of one trace from the state `reset` made, as a
        generator. The unrolled form runs all max_bounces + 2, the last
        one thin, as one step; the looped form runs blocks of LOOP_BLOCK
        until no lane is live or the cap is reached, and between blocks
        enqueues the live count's copy to the host, yields this trace
        and takes the count back (`live_count()`) from `send`. With
        `resort` every segment after the first runs on a resorted state
        over its live prefix; the first traces the camera rays in their
        own order unless `sort_first`, which sorts them inside
        traversal. The segments run are the device's `bounce`."""
        if self.unroll:
            self.steps.run("unrolled", lambda: self.unrolled(scene))
            return
        for start in range(0, self.n_segments, LOOP_BLOCK):
            if start:
                if self._landed is not None:
                    self._live_host.copy_(self.live, non_blocking=True)
                    self._landed.record(
                        torch.cuda.current_stream(self.live.device))
                if (yield self) == 0:
                    return
            first = min(start, LOOP_BLOCK)  # later blocks share a step
            self.steps.run(("block", first),
                           lambda: self._block(scene, first))

    def unrolled(self, scene) -> None:
        """Every segment of the unrolled form (a step's work)."""
        for pos in range(self.n_segments):
            self._segment(scene, pos, pos == self.n_segments - 1)
            self._advance()

    def _advance(self) -> None:
        """A segment's tail: the device's segment count += 1 (under
        capture the looped form's tail kernel does it, graphs.loop)."""
        with record_function("live_count"):
            self.bounce += 1

    def _block(self, scene, first: int) -> None:
        """LOOP_BLOCK segments of the looped form from position `first`
        (0 or LOOP_BLOCK; a later block replays the latter's step), each
        after the first position under the loop's cond, each followed by
        its tail (`_advance`); the first block holds no position past the
        cap."""
        go = ((self.live, ">", 0), (self.bounce, "<", self.n_segments))
        stop = first + LOOP_BLOCK if first else min(LOOP_BLOCK,
                                                     self.n_segments)
        # every lane is live after reset: the first block's first
        # segment runs unguarded
        graphs.loop(go, [lambda pos=pos: self._segment(scene, pos, False)
                         for pos in range(first, stop)],
                    self.bounce, self._advance, guard_first=first > 0)

    def _segment(self, scene, pos: int, last: bool) -> None:
        """The segment at position pos: its roulette (bounce > 3, the one
        branch on the bounce taken on the host) and under `resort` the
        set it reads follow pos; the resorted widths are chosen on the
        device (graphs.choose) among _widths(n) where n >= _SHRINK_MIN."""
        roulette = pos > 3
        if not (self.resort and pos > 0):
            # only the camera rays' segment runs over all lanes when the
            # loop resorts: it reads the first set
            self._body(scene, last, roulette,
                       self.resort and not self.sort_first)
            return
        src, n = (pos - 1) % 2, self.n
        if n < _SHRINK_MIN:
            self._resorted(scene, src, n, n, last, roulette)
            return
        widths = _widths(n)
        prev, w = self.widx[(pos - 1) % 2], self.widx[pos % 2]
        _width_index(self.live, self.bounds, out=w)
        # a branch a (prefix, width) pair, width <= prefix; the prefix is
        # the last segment's width, all lanes after the camera rays'
        prefixes = (2,) if pos == 1 else (0, 1, 2)
        graphs.choose((prev, w), {
            (p, k): (lambda p=p, k=k: self._resorted(
                scene, src, widths[p], widths[k], last, roulette))
            for p in prefixes for k in range(p + 1)})

    def _body(self, scene, last, roulette, presorted) -> None:
        st = self.bufs[0]
        out = _bounce_body(scene, self.cfg, self.bounce, st, last=last,
                           resort=presorted, roulette=roulette,
                           live=self.live)
        with record_function("store"):
            _store(st, out)

    def _resorted(self, scene, src, prefix, width, last, roulette) -> None:
        """Resort the first `prefix` lanes of set `src` into the other
        set, then a bounce over its first `width` lanes there."""
        st = self.bufs[1 - src]
        with record_function("resort"):
            _resort_state(scene, self.bufs[src], out=st, prefix=prefix,
                          width=width)
        _bounce_shrunk(scene, self.cfg, self.bounce, st, last, width,
                       roulette, live=self.live)

    def live_count(self) -> int:
        """The live count whose copy `run` enqueued before it yielded,
        once the copy has landed: a block's one host read."""
        if self._landed is not None:
            self._landed.synchronize()
        graphs.count("reads")
        return int(self._live_host)

    def with_state(self, fn) -> None:
        """fn(i) for the set of buffers, bufs[i], that holds the state
        after `run` (inside a step): set 0 without the resort, the
        unrolled form's last set, else the parity of the device's segment
        count, chosen on the device."""
        if not self.resort:
            fn(0)
        elif self.unroll:
            fn((self.n_segments - 1) % 2)
        else:
            graphs.choose(torch.remainder(self.bounce, 2),
                          {1: lambda: fn(0), 0: lambda: fn(1)})

    def radiance(self, i: int) -> torch.Tensor:
        """Radiance of set i in pixel order (the lanes moved under
        `resort`)."""
        st = self.bufs[i]
        if not self.resort:
            return st["radiance"]
        return torch.empty_like(st["radiance"]).index_copy_(
            0, st["pix"], st["radiance"])


def run_alone(steps):
    """Drive a resumable trace or frame (`_Trace.run`, renderer's
    `_Frame.run`) to its end on its own: it gets each live count as soon
    as the count has landed. Returns the generator's value."""
    try:
        trace = next(steps)
        while True:
            trace = steps.send(trace.live_count())
    except StopIteration as done:
        return done.value


def _run_key(scene) -> tuple:
    """The scene's part of a run shape's key: its fingerprint and what
    dispatch reads at run time besides it (graphs.py)."""
    mode = ("tlas" if getattr(scene, "tlas", None) is not None
            else _hbm_mode(scene.wide))
    return graphs.fingerprint(scene), mode, _shadow_compact()


def _trace_form(scene, cfg: PathConfig, n: int, staged: bool):
    """(resort, unroll, sort_first) of trace_paths (staged=False) or
    trace_paths_staged for n lanes."""
    if staged:
        return _resolve_resort(scene, cfg), True, True
    unroll = (cfg.unroll if cfg.unroll is not None
              else cfg.max_bounces + 2 <= 10)
    return _resolve_resort(scene, cfg, n), unroll, False


def _new_trace(scene, cfg: PathConfig, n: int, staged: bool) -> _Trace:
    """An uncached _Trace of n lanes on the scene's device. Its steps are
    graphed on a CUDA device unless the dispatch is the per-lane walk
    ('lanes'), whose loop reads its live lanes on the host at every
    step of the walk (accel/traverse.py): a graph cannot hold it."""
    key = _run_key(scene)
    return _Trace(n, scene.device, cfg, *_trace_form(scene, cfg, n, staged),
                  capture=key[1] != "lanes")


def _trace_rays(scene, ray_o, ray_d, rng_state, cfg: PathConfig,
                staged: bool):
    n = ray_o.shape[0]
    key = ("trace", _run_key(scene), cfg, n, staged)
    tr = graphs.run_shape(key, lambda: _new_trace(scene, cfg, n, staged),
                          scene)
    with tr.lock:
        _store(tr.bufs[0], dict(o=ray_o, d=ray_d, rng=rng_state))
        if tr.out is None:  # static: the finish step writes them
            tr.out = dict(radiance=torch.empty_like(tr.bufs[0]["radiance"]),
                          rng=torch.empty_like(tr.bufs[0]["rng"]))
        out = tr.out

        def finish():
            tr.with_state(lambda i: _store(out, dict(
                radiance=tr.radiance(i), rng=tr.bufs[i]["rng"])))

        tr.steps.run("reset", tr.reset)
        run_alone(tr.run(scene))
        tr.steps.run("finish", finish)
        segments = tr.n_segments
        if not tr.unroll:  # the looped form's count is the device's
            graphs.count("reads")
            segments = int(tr.bounce)
        return (out["radiance"].clone(), out["rng"].clone(),
                tr.bufs[0]["rays"].clone(), segments)


def trace_paths(scene, ray_o, ray_d, rng_state, cfg: PathConfig):
    """Estimate incoming radiance along N rays.

    Returns (radiance [N,3], rng_state, rays_traced int64 scalar, segments)
    where rays_traced counts the closest-hit and shadow rays issued for
    live lanes (the Mrays/s numerator, path.py:400,580 of the reference)
    and segments is the number of bounce segments run (one closest-hit
    dispatch each). The unrolled form (auto for max_bounces + 2 <= 10)
    runs every segment; the looped one stops when no lane is live. The
    resort follows `_resolve_resort` for this lane count. On a CUDA
    device the rays are copied into the run shape's static buffers and
    each segment is a graph replay (graphs.py)."""
    return _trace_rays(scene, ray_o, ray_d, rng_state, cfg, staged=False)


def trace_paths_staged(scene, ray_o, ray_d, rng_state, cfg: PathConfig):
    """trace_paths for very large lane counts (the reference's staged
    path): every segment runs, the resort stays on at any lane count
    (`_resolve_resort`), and the first segment sorts inside traversal.
    Same per-lane RNG consumption as trace_paths, so the image matches it;
    returns what trace_paths returns."""
    return _trace_rays(scene, ray_o, ray_d, rng_state, cfg, staged=True)
