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

The loop (`_Trace`) keeps its state in static buffers and runs each
segment as a step of graphs.Steps: on a CUDA device a graph replay, on
the CPU (and inside graphs.eager()) the same functions eagerly. A
segment reads nothing on the host; the loop reads the live count
between segments where it needs it.

A segment's shading (the env miss, the surface decode, the env draw and
the light weighting with the BSDF scatter) is integrator/shade.py: a
kernel of csrc/shade.cu each on the card, the plain torch version on the
CPU. The termination, the mesh-light draw, the shadow batch and the
resort stay torch ops.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..accel import packet, tlas as tlas_mod, traverse, treelet
from ..bsdf import materials as B
from ..core import rng as R
from ..core.mathutil import (
    INF_T,
    face_forward,
    luminance,
    norm,
    offset_along_normal,
)
from ..lights.mesh_lights import sample_mesh_lights
from ..scene import textures as TX
from ..scene.textures import sample_material_block
from . import graphs, shade
from .shade import _interp


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


def _emissive_at(scene, light_row, bary):
    """Emitted radiance at a light sample from its packed emitter row."""
    if scene.mat_atlas.emissive_constant:
        return light_row[:, 15:18]
    n = light_row.shape[0]
    uv = _interp(bary[..., 0], bary[..., 1], light_row[:, 9:15].reshape(n, 3, 2))
    block = sample_material_block(scene.mat_atlas.emissive,
                                  light_row[:, 18:22], uv)
    return block[:, TX.EMISSIVE]


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


# the profiler ranges a bounce opens around its stages, in order
# (render/profile_frame.py splits a sample's kernel time by them); the
# direct integrator opens the same ones
STAGES = ("traversal", "env", "surface", "nee_draw", "any_hit", "scatter",
          "resort")


def _bounce_body(scene, cfg: PathConfig, bounce, st: dict,
                 last: bool = False, resort: bool = False,
                 roulette: bool | None = None) -> dict:
    """One bounce over the whole lane batch. `bounce` is an int or a
    device scalar (the graphed loop's, so that one graph serves many
    bounces); `roulette` is whether bounce > 3, the one branch on it taken
    on the host (by default read from an int bounce). last=True marks the
    final segment of the unrolled form, where every lane dies after the
    emissive/miss accumulation, so NEE, roulette and scatter are skipped.
    resort=True: the state is coherence-sorted, so traversal skips its
    own sort. Each stage runs inside a profiler range (STAGES); the
    miss, the surface decode, the env draw and the scatter are kernels of
    csrc/shade.cu (integrator/shade.py)."""
    if roulette is None:
        roulette = bounce > 3
    active = st["active"]
    o, d = st["o"], st["d"]
    throughput = st["throughput"]
    last_pdf = st["last_pdf"]
    last_delta = st["last_delta"]
    rng = st["rng"]
    rays = st["rays"] + active.sum()

    with record_function("traversal"):
        hit = _closest(scene, o, d, INF_T, active, presorted=resort)
    # ---- miss: environment radiance (integrator.hlsl:166-180)
    with record_function("env"):
        radiance = shade.env_miss(scene.env, cfg.env_samples_per_bounce,
                                  bounce, d, active, hit.tri, throughput,
                                  st["radiance"], last_pdf, last_delta)
    active = active & hit.is_hit

    # ---- decode the surface and add its emission (integrator.hlsl:93-124)
    with record_function("surface"):
        surf = shade.surface(scene, cfg.mesh_samples_per_bounce, bounce, hit,
                             o, d, active, throughput, radiance, last_pdf,
                             last_delta, shade.THIN if last else shade.FULL)
    if last:
        # the max-bounce cut kills every lane here
        return dict(st, active=surf.active, radiance=surf.radiance,
                    rays=rays)

    with record_function("nee_draw"):
        # ---- termination (integrator.hlsl:126-135)
        active = active & (bounce < cfg.max_bounces + 1)
        rng, rr_rand = R.next_float(rng)
        if roulette:
            p_survive = torch.clamp_max(luminance(throughput), 0.95)
            active = active & ~(rr_rand > p_survive)
            throughput = torch.where(
                active[..., None],
                throughput / torch.clamp_min(p_survive, 1e-20)[..., None],
                throughput)

        nee_active = active & ~B.is_delta(surf.mat.type)
        position, tri_n = surf.position, surf.tri_n

        # ---- NEE (integrator.hlsl:139-151): draw every light sample,
        # trace all shadow rays as one any-hit batch, then weight
        shadow = []  # (origin, dir, tmax, lane, n_samples, l_dir, l_rad,
        #             l_pdf)
        for _ in range(cfg.env_samples_per_bounce):
            rng, r2 = R.next_float2(rng)
            l_dir, l_rad, l_pdf = shade.env_draw(scene.env, r2)
            shadow_o = offset_along_normal(position,
                                           face_forward(tri_n, l_dir))
            shadow.append((shadow_o, l_dir, torch.full_like(l_pdf, INF_T),
                           nee_active & (l_pdf > 0.0),
                           cfg.env_samples_per_bounce, l_dir, l_rad, l_pdf))
        for _ in range(cfg.mesh_samples_per_bounce):
            rng, r2 = R.next_float2(rng)
            l_dir, l_pos, l_n, _tri, l_bary, l_pdf, l_row = (
                sample_mesh_lights(scene, position, r2))
            l_rad = _emissive_at(scene, l_row, l_bary)
            # two-ended shadow segment (light.hlsl:149-154)
            off_light = offset_along_normal(l_pos, l_n)
            off_shade = offset_along_normal(position,
                                            face_forward(tri_n, l_dir))
            seg = off_light - off_shade
            seg_len = norm(seg)[..., 0]
            seg_dir = seg / torch.clamp_min(seg_len, 1e-20)[..., None]
            shadow.append((off_shade, seg_dir, seg_len,
                           nee_active & (l_pdf > 0.0),
                           cfg.mesh_samples_per_bounce, l_dir, l_rad, l_pdf))

    lights = []
    if shadow:
        with record_function("any_hit"):
            # shadow rays inherit the (possibly resorted) lane order
            occ_all = _any_hit(
                scene,
                torch.cat([b[0] for b in shadow]),
                torch.cat([b[1] for b in shadow]),
                torch.cat([b[2] for b in shadow]),
                torch.cat([b[3] for b in shadow]),
                presorted=resort and not (_shadow_compact()
                                            and scene.has_delta),
            )
        n = position.shape[0]
        for i, (_, _, _, lane, n_samples, l_dir, l_rad, l_pdf) in enumerate(
                shadow):
            rays = rays + lane.sum()
            lights.append(shade.Light(l_dir, l_rad, l_pdf, lane,
                                      occ_all[i * n:(i + 1) * n], n_samples))

    # ---- weight the light samples and scatter (integrator.hlsl:139-163)
    with record_function("scatter"):
        out = shade.scatter(surf, o, d, throughput, surf.radiance, rng,
                            active, lights)
    return dict(st, **out, rays=rays)


def _resort_state(scene, st: dict) -> dict:
    """Reorder every lane array of the state by ray coherence: 8^3 origin
    cells x direction octant, dead lanes keyed 1 << 20 so they form the
    tail (a stable sort). Lanes keep their RNG streams and pixel ids. A
    scene without a wide tree keeps the state as it is."""
    if scene.wide is None:
        return st
    o, d, active = st["o"], st["d"], st["active"]
    lo = scene.wide.bounds[0]
    inv_ext = 1.0 / torch.clamp_min(scene.wide.bounds[1] - lo, 1e-20)
    cell = torch.clamp(((o - lo) * inv_ext * 8.0).to(torch.int32), 0, 7)
    octant = ((d[:, 0] > 0).to(torch.int32) * 4
              + (d[:, 1] > 0).to(torch.int32) * 2
              + (d[:, 2] > 0).to(torch.int32))
    key = ((cell[:, 0] * 8 + cell[:, 1]) * 8 + cell[:, 2]) * 8 + octant
    key = torch.where(active, key, 1 << 20)
    perm = torch.argsort(key, stable=True)
    n = o.shape[0]
    return {k: (v[perm] if _is_lane(v, n) else v) for k, v in st.items()}


def _is_lane(v, n: int) -> bool:
    return torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == n


_SHRINK_MIN = 4 * 1024  # lanes below which the live prefix is not worth it


def _prefix_width(n: int, live: int) -> int:
    """The lanes a resorted bounce runs over: a quarter or a half of the n
    lanes when the live count fits, else all (all below _SHRINK_MIN)."""
    if n < _SHRINK_MIN:
        return n
    return n // 4 if live <= n // 4 else (n // 2 if live <= n // 2 else n)


def _store(dst: dict, src: dict) -> None:
    """Copy src's values into dst's tensors in place (skipping any that
    already is dst's): a step leaves its results in static buffers."""
    for k, v in src.items():
        if v is not dst[k]:
            dst[k].copy_(v)


def _bounce_shrunk(scene, cfg: PathConfig, bounce, st: dict, last: bool,
                   width: int, roulette: bool = False) -> dict:
    """A bounce over the first `width` lanes of a resorted state (live
    lanes first; `_prefix_width` of the live count), written into that
    prefix of `st` in place. Dead lanes' state is final, so the image is
    unchanged; their RNG stops advancing, which nothing observes."""
    n = st["o"].shape[0]
    head = {k: (v[:width] if _is_lane(v, n) else v) for k, v in st.items()}
    _store(head, _bounce_body(scene, cfg, bounce, head, last=last,
                              resort=True, roulette=roulette))
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


class _Trace:
    """The bounce loop of one run shape (scene, lane count, cfg and form)
    over static state: the lane arrays, the device bounce index and the
    live count. Each segment is one step of `steps` (graphs.Steps),
    keyed by what its body does: (last, roulette, presorted) for a body
    over all lanes, or the prefix width for a resorted one. Between
    segments the loop reads the live count, one device-to-host read that
    serves both the looped form's stop and the prefix width (the
    reference's lax.cond, path.py:687-711 there); the unrolled form
    without resort reads nothing.

    `run` is resumable at that read: it enqueues the count's copy to the
    host and yields this trace, and the caller sends back `live_count()`
    (`run_alone` does so at once; parallel/sharding.py first enqueues
    every other shard's segment)."""

    def __init__(self, n: int, device, cfg: PathConfig, resort: bool,
                 unroll: bool, sort_first: bool, capture: bool):
        self.cfg, self.resort = cfg, resort
        self.unroll, self.sort_first = unroll, sort_first
        rays = torch.empty((n, 3), dtype=torch.float32, device=device)
        self.st = _init_state(rays, torch.empty_like(rays),
                              torch.empty(n, dtype=torch.int64,
                                          device=device))
        self.bounce = torch.empty((), dtype=torch.int64, device=device)
        self.live = torch.empty_like(self.bounce)
        # the live count on the host: on a card a pinned copy, made
        # without blocking, and an event that says when it has landed
        self._live_host, self._landed = self.live, None
        if self.live.device.type == "cuda":
            self._live_host = torch.empty((), dtype=torch.int64,
                                          pin_memory=True)
            self._landed = torch.cuda.Event()
        self.steps = graphs.Steps(device, capture)
        # held by a caller from loading the buffers to reading them
        self.lock = threading.Lock()

    def reset(self) -> None:
        """The state of fresh camera rays, whose o, d and rng the caller
        wrote (a step's work)."""
        st = self.st
        n = st["pix"].shape[0]
        st["active"].fill_(True)
        st["throughput"].fill_(1.0)
        st["radiance"].zero_()
        st["last_pdf"].fill_(1.0)
        st["last_delta"].zero_()
        st["rays"].zero_()
        torch.arange(n, out=st["pix"])
        self.bounce.zero_()

    def run(self, scene):
        """The segments of one trace from the state `reset` made, as a
        generator whose value is the segments run. The unrolled form runs
        all max_bounces + 2, the last one thin; the looped form stops as
        soon as no lane is live. With `resort` every segment after the
        first runs on a resorted state over its live prefix; the first
        traces the camera rays in their own order unless `sort_first`,
        which sorts them inside traversal. Where a segment needs the live
        count, the generator enqueues its copy to the host, yields this
        trace and takes the count back (`live_count()`) from `send`."""
        n = self.st["pix"].shape[0]
        n_segments = self.cfg.max_bounces + 2
        for bounce in range(n_segments):
            shrink = self.resort and bounce > 0
            live = n  # reset made every lane live
            if bounce > 0 and (not self.unroll
                               or (shrink and n >= _SHRINK_MIN)):
                if self._landed is not None:
                    self._live_host.copy_(self.live, non_blocking=True)
                    self._landed.record(
                        torch.cuda.current_stream(self.live.device))
                live = yield self
            if not self.unroll and live == 0:
                return bounce
            last = self.unroll and bounce == n_segments - 1
            roulette = bounce > 3
            if shrink:
                width = _prefix_width(n, live)
                self.steps.run(
                    ("resorted", width, last, roulette),
                    lambda: self._resorted(scene, width, last, roulette))
            else:
                presorted = self.resort and not self.sort_first
                self.steps.run(
                    ("body", last, roulette, presorted),
                    lambda: self._body(scene, last, roulette, presorted))
        return n_segments

    def _body(self, scene, last, roulette, presorted) -> None:
        _store(self.st, _bounce_body(scene, self.cfg, self.bounce, self.st,
                                     last=last, resort=presorted,
                                     roulette=roulette))
        self._advance()

    def _resorted(self, scene, width, last, roulette) -> None:
        with record_function("resort"):
            st = _resort_state(scene, self.st)
        _store(self.st, _bounce_shrunk(scene, self.cfg, self.bounce, st,
                                       last, width, roulette))
        self._advance()

    def _advance(self) -> None:
        self.bounce += 1
        self.live.copy_(self.st["active"].sum())

    def live_count(self) -> int:
        """The live count whose copy `run` enqueued before it yielded,
        once the copy has landed: the segment's one host read."""
        if self._landed is not None:
            self._landed.synchronize()
        graphs.count("reads")
        return int(self._live_host)

    def radiance(self) -> torch.Tensor:
        """Radiance in pixel order (the lanes moved under `resort`)."""
        radiance = self.st["radiance"]
        if not self.resort:
            return radiance
        return torch.empty_like(radiance).index_copy_(0, self.st["pix"],
                                                      radiance)


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
        _store(tr.st, dict(o=ray_o, d=ray_d, rng=rng_state))
        tr.steps.run("reset", tr.reset)
        segments = run_alone(tr.run(scene))
        radiance = tr.radiance()
        if radiance is tr.st["radiance"]:
            radiance = radiance.clone()
        return (radiance, tr.st["rng"].clone(), tr.st["rays"].clone(),
                segments)


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
