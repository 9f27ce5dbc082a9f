"""Smoke run of the PyTorch/CUDA port (moonshine_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME, PATH or /usr/local/cuda). Each
phase prints lines tagged with its name; a failing phase raises and the
script exits non-zero without the result line. Phases:

  device          the card's name and power limit (nvidia-smi)
  build           nvcc builds csrc/traverse.cu, csrc/treelet.cu,
                  csrc/vpacket.cu, csrc/vpu.cu, csrc/bitcast.cu,
                  csrc/tlas.cu, csrc/shade.cu, csrc/sort.cu,
                  csrc/graph_cond.cu and csrc/frame.cu into build/, one
                  process each, started together; prints each kernel's
                  registers, shared memory and spills (ptxas)
  scenes          flagship, room_184k (SAH, 24-wide / 24-slot) and
                  room_184k as the treelet build (MSN_WIDE=8
                  MSN_LEAF_CAP=8): builder, layout, row bytes against the
                  reference's 10 MiB budget, dispatch mode, stack bound, K
  kernels         each kernel against its plain torch version (packet
                  kernels on flagship and room_184k; treelet phase 1 and
                  walk bit for bit on the treelet build, the walk also
                  against the packet kernel there): camera rays plus a
                  seeded bounce batch with dead lanes
  flagship        render_spp of the flagship, 512x512, 8 spp, after a
                  warm-up run; Mrays/s from one run's rays and time
  goldens         furnace (every pixel 1) and mirror_glass against the
                  committed golden image
  room_184k       render_spp of room_184k, 512x512, 2 spp (fused path)
  room_1080p      room_184k, 1920x1080 x 2 spp through render_spp (the
                  staged path, resort on), packet kernels, the shading
                  kernels (a surface and env-miss launch a segment, a
                  scatter launch a shadow batch; every full surface
                  launch and scatter counting), the lane sort (the
                  camera rays' two sorted dispatches with their inverse
                  moves, a resort before each later segment) and a
                  sample's camera rays and accumulation (one launch each)
  treelet_1080p   the same frame with MSN_TREELETS=1 on the treelet build,
                  treelet kernels (a phase-1 launch, a sort and an inverse
                  move per walk launch); its image against room_1080p's
  staged_vs_fused room_184k 512x512 x 1 spp through both paths
  timings         each kernel at the largest shape of the 1080p main path
                  (2,073,600 closest-hit rays, 4,147,200 shadow rays): the
                  kernel held against its plain version there (the packet
                  and treelet kernels bit for bit) and timed beside it, its
                  bound from the plain version's visit counts; the treelet
                  dispatch's phase-1 kernel against its torch version (bit
                  for bit, both timed, with the torch version's traffic;
                  also at treelet_1080p's bounce-3 closest hit, recorded;
                  the all-pairs bound and the culled work's beside it),
                  the whole treelet wrappers and the walk's shape (block,
                  stack bound, root visits skipped); the packet kernels'
                  launch layout (G, R, block, shared bytes) and three
                  alternated rounds of them against the format-V kernels
  vpacket         format-V tiles of both room_184k trees: the V kernels'
                  launch layout (G, shared bytes, as vpacket.kernel_layout
                  and the kernel count it), the kernels against their
                  plain versions and the packet kernel on
                  the test batch and at the 1080p launches (bit for bit),
                  timed beside the packet kernel with bounds; then the
                  row-versus-V entry point (scripts/profile_vpacket.py)
  fallback        the dispatch forced into the per-lane walk of the binary
                  BVH (accel/traverse.py): the flagship 256x256 x 1 spp
                  against the default path, and the walk on 262,144
                  camera rays against the packet kernel, timed
  vpu             the slab and ALU microbenchmark kernels against their
                  plain versions, every configuration at 1, 20, 127 and
                  129 visits and at 2000, on the reference's inputs and
                  on seeded ones (where lanes hit); the latency probe
                  (cycles of each operation class, the SM clock, the ALU
                  chain's floor) and an empty kernel's time; then the
                  entry point
                  (scripts/profile_vpu.py) at 2000 visits, each
                  configuration's time beside its bound and floors
  bitcast         the quantised-row decode kernel against its plain
                  version bit for bit at the six row widths (the
                  reference's rows and seeded ones), the probe's entry
                  point in-process (launches counted) and as
                  `python -m moonshine_tpu_torch.scripts.probe_bitcast`,
                  then the kernel timed at each width
  presplit        room_184k built under MSN_PRESPLIT=1.35 (SBVH
                  references): its size against the default build, the
                  packet kernels against their plain versions on it, its
                  visits and kernel times at the 1080p launches beside
                  the default tree's, and a 512x512 x 2 spp render
                  against the default build's
  offline         the offline CLI: (a) the Cornell glb at the golden's
                  settings through `python -m
                  moonshine_tpu_torch.render.offline` against
                  tests/goldens/cornell.exr; (b) room_184k written as a glb
                  (184,332 triangles) with a 2048x1024 ZIP skybox, its
                  glTF build against the source World's, then the CLI at
                  its defaults (1280x720, max_bounces 1024) with --spp 4,
                  launches counted, against an in-process render
  jpeg            every committed JPEG fixture (tests/torch_fixtures/:
                  baseline, progressive, restarts, CMYK, YCCK, lossless,
                  arithmetic-coded sequential and progressive, block
                  smoothing) against its PIL golden bit for bit; a seeded
                  2048x2048 texture's decode timed on this host, Huffman
                  and arithmetic-coded (scripts/time_jpeg.py); the Cornell
                  glb with a JPEG texture through the CLI against an
                  in-process render
  engine          room_184k entered through the Engine's handles, 1280x720
                  at the Engine's defaults (max_bounces 1024, NEE off, no
                  flip): 4 frames of 1 spp (ms/frame, Mrays/s), their
                  packet-kernel launches held against the plain versions;
                  set_transform's refit against a full build, the packet
                  kernels bit for bit on the refit rows and closest-hit t
                  against the full build's; a material-only rebuild; how
                  long render(wait=False) blocks; a pick from a second
                  thread during a frame; a checkpoint round trip
  direct          trace_direct on room_184k's 1920x1080 camera rays (one env
                  and one mesh-light sample), timed, its launches held
                  against the plain versions
  sharded         render_sharded on cuda:0 x4 (sp=2, dp=2) and on
                  mesh_from_spec("auto") against the one-device render
                  (512x512 x 2 spp, within 2e-6 x max(1, |pixel|)), launches
                  held against the plain versions; then room_1080p
                  (1920x1080 x 2 spp, each shard staged) on both meshes:
                  ms per call after a warm-up, replays, reads, captures
                  (none after the warm-up) and scene copies a call, the
                  image bit for bit against the same shards run in turn
                  and within 2e-6 x max(1, |pixel|) of the one-device
                  render, rays and launches equal, one call profiled (each
                  card's busy share, the shards' overlap on one card), one
                  recorded and its launches held against the plain
                  versions at the shards' shapes; the Cornell CLI with
                  --mesh auto against tests/goldens/cornell.exr
  viewer          run_web on a free local port: GET /frame.png decodes to
                  tonemap of the sensor; a material edit and a key reset
                  the sample count
  tlas            instanced_1080p: procedural.instanced_scene() (4096
                  instances of icosphere(6), 335,544,320 triangles
                  flattened) built two-level by the cap, with its warning;
                  1920x1080 x 2 spp through csrc/tlas.cu (launches counted
                  from 0 for the timed run); a recorded 1-spp run's first
                  and a later launch of each kind held against the plain
                  versions bit for bit on 65,536 lanes; the kernels at the
                  frame's largest launches bit for bit, timed, bounded by
                  the plain versions' visit counts and by the kernel's own
                  (its counting build); procedural.tie_scene's exact
                  equal-t ties on 65,536 rays bit for bit; a 40-instance
                  world flattened against two-level (the reference's
                  bounds)
  shade           the shading kernels of csrc/shade.cu (surface in its
                  full and thin forms, scatter, env miss, env draw): one
                  eager sample of room_1080p and of instanced_1080p
                  recorded, each kernel's first launch (2,073,600 lanes)
                  replayed through the kernel and its plain version, every
                  output bit for bit, both timed, with the bound from the
                  bytes and operations of those inputs; the env miss also
                  at live shares of 10% and 1% of its launch
  sort            the lane sort of csrc/sort.cu (core/sortutil.py): each
                  site's first call in an eager 1080p sample (the resort
                  and the packet sorts of room_1080p at 2,073,600 lanes,
                  the shadow batch's at 4,147,200, treelet_1080p's)
                  replayed through the kernels and the plain version:
                  the coherence key that the sort's first kernel makes
                  from its inputs against coherence_key_plain, the
                  permutation against torch.argsort(key, stable=True) and
                  every moved
                  column bit for bit (the recording and the helpers are
                  scripts/compare_sort.py's); each
                  timed beside the argsort alone, the plain version, the
                  parent's argsort + gathers + copy back and the bound;
                  the permutation passes and the move also apart, beside
                  their bounds (the move's by bytes and by 32-byte
                  sectors); the whole resort against the parent's; the
                  inverse move
                  the same way; then room_1080p and an offline_720p sample
                  with the plain versions patched in against the kernels'
                  run (image, rays, launches)
  shadow_compact  room_1080p with MSN_SHADOW_COMPACT=1 (each resorted
                  segment's shadow batch sorted inside the any-hit
                  dispatch) as graph replays against the default: image,
                  rays and the traversal and shading launches bit for bit
  graphs          the conditional nodes' set kernel (csrc/graph_cond.cu,
                  under graphs.cond / choose) held against its plain
                  version (sel == value; a six-branch SWITCH node at
                  every (prev, w) pair) and the loop's tail (graphs.loop)
                  against the eager loop, and timed: a skipped IF node,
                  a six-branch switch matching none, a segment guard in
                  the earlier form and folded into the tail, and a host
                  read of the live count; then
                  the bounce loop as CUDA graph replays (every phase above
                  runs them; the recorded runs use the eager loop) against
                  the eager loop (integrator/graphs.py eager()) on
                  room_184k (512x512), room_1080p, one offline_720p
                  sample, engine_720p frames and instanced_1080p: image,
                  rays and launches bit for bit; each way the conds,
                  reads and replays of a sample (0 reads for the unrolled
                  cells, at most ceil(segments / LOOP_BLOCK) + 1 for the
                  looped ones), ms/spp, kernels, graph replays, host
                  dispatches and reads, the device's idle share
                  (render/profile_frame.py `profile`) and peak memory;
                  one more eager sample split by the stage ranges
                  (integrator/path.py STAGES)
  frame           the kernels of csrc/frame.cu against their plain
                  versions bit for bit at room_1080p's 2,073,600 lanes,
                  offline_720p's 921,600, a 540-row band and 1024x576 x 3
                  samples a batch (tiled): the camera rays with the fresh
                  lane state (every buffer and scalar), the accumulation
                  (with the resort's pix), each timed beside its plain
                  version and its byte bound; the counts folded into the
                  surface and scatter kernels on room_1080p's first
                  launches, exactly against the plain versions and the
                  masks' torch sums, the kernels timed with and without
                  them beside the torch reductions they replace and
                  torch.count_nonzero; the eager stage split of
                  room_1080p and offline_720p (the camera range one
                  raygen launch a sample, the live_count range no
                  reduction, the env range the miss kernel alone)
  capi            build/libmoonshine_tpu_torch.so built with g++ and loaded
                  with ctypes here: native/test_shim.cpp's scene through
                  Msn* calls on the card (engine on cuda, traversal
                  launches counted, the sensor against the Engine's render
                  bit for bit, the EXR round trip); then the port's copy
                  of that C++ host as a subprocess, "shim ok"

The line before the last is {"kernels": [...]} (each entry also names
the CUDA kernels its wrapper launches, `cuda_kernels`); the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"  # files the offline phase writes (gitignored)
INF_T = 1.0e12
HD = (1080, 1920)
# the card's published peaks (H100 SXM, NVIDIA's data sheet): fp32 outside
# the tensor cores, bf16 (the data sheet's rate, a tensor-core one), and HBM
# bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# bf16 outside the tensor cores, the rate of elementwise bf16 math (NVIDIA
# H100 Tensor Core GPU Architecture white paper, SXM5: 133.8 TFLOP/s, an
# FMA counting two, as the 67 TFLOP/s fp32 rate counts it)
PEAK_BF16_VECTOR = 133.8e12
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "closest_hit": ("moonshine_tpu_torch/csrc/traverse.cu",
                    "moonshine_tpu/accel/packet.py:825"),
    "any_hit": ("moonshine_tpu_torch/csrc/traverse.cu",
                "moonshine_tpu/accel/packet.py:860"),
    "treelet_closest_hit": ("moonshine_tpu_torch/csrc/treelet.cu",
                            "moonshine_tpu/accel/treelet.py:510"),
    "treelet_any_hit": ("moonshine_tpu_torch/csrc/treelet.cu",
                        "moonshine_tpu/accel/treelet.py:510"),
    "treelet_pending": ("moonshine_tpu_torch/csrc/treelet.cu",
                        "moonshine_tpu/accel/treelet.py:372 _pending_masks "
                        "(jnp, no pallas_call)"),
    "v_closest_hit": ("moonshine_tpu_torch/csrc/vpacket.cu",
                      "moonshine_tpu/accel/vpacket.py:546"),
    "v_any_hit": ("moonshine_tpu_torch/csrc/vpacket.cu",
                  "moonshine_tpu/accel/vpacket.py:580"),
    "vpu_slab": ("moonshine_tpu_torch/csrc/vpu.cu",
                 "scripts/profile_vpu.py:101"),
    "vpu_alu": ("moonshine_tpu_torch/csrc/vpu.cu",
                "scripts/profile_vpu.py:137"),
    "bitcast": ("moonshine_tpu_torch/csrc/bitcast.cu",
                "scripts/probe_bitcast.py:63"),
    "tlas_closest_hit": ("moonshine_tpu_torch/csrc/tlas.cu",
                         "moonshine_tpu/accel/tlas.py:228 closest_hit_tlas "
                         "(jnp while_loop, no pallas_call)"),
    "tlas_any_hit": ("moonshine_tpu_torch/csrc/tlas.cu",
                     "moonshine_tpu/accel/tlas.py:325 any_hit_tlas "
                     "(jnp while_loop, no pallas_call)"),
    "surface": ("moonshine_tpu_torch/csrc/shade.cu",
                "moonshine_tpu/integrator/path.py:424 _bounce_body's hit "
                "decode (_decode_hit :139, _decode_material :214, "
                "core/gather.py:61 gather_rows, :78 shift_gather_rows) and "
                "its light draw (:503-573, lights/mesh_lights.py:29-71; jnp, "
                "no pallas_call)"),
    "scatter": ("moonshine_tpu_torch/csrc/shade.cu",
                "moonshine_tpu/integrator/path.py:583 _bounce_body's light "
                "weighting and scatter (bsdf/materials.py:278-370; jnp, no "
                "pallas_call)"),
    "env_miss": ("moonshine_tpu_torch/csrc/shade.cu",
                 "moonshine_tpu/lights/envmap.py:175 miss_radiance_and_pdf "
                 "with path.py:404 (core/gather.py:61, :126 "
                 "weighted_gather_rows; jnp, no pallas_call)"),
    "env_draw": ("moonshine_tpu_torch/csrc/shade.cu",
                 "moonshine_tpu/lights/envmap.py:134 sample_envmap on the "
                 "direct integrator's path (core/gather.py:61 gather_rows; "
                 "jnp, no pallas_call)"),
    "sort_lanes": ("moonshine_tpu_torch/csrc/sort.cu",
                   "moonshine_tpu/core/sortutil.py:22 sort_lanes (jnp "
                   "lax.sort, no pallas_call) with its keys, "
                   "accel/packet.py:651 _sort_key and integrator/path.py:"
                   "638-647 _resort_state's key (jnp), made in its first "
                   "kernel"),
    "unsort_lanes": ("moonshine_tpu_torch/csrc/sort.cu",
                     "moonshine_tpu/accel/packet.py:690 _sorted_dispatch's "
                     "inverse sort_lanes by the lane iota (jnp lax.sort, no "
                     "pallas_call)"),
    "graph_if": ("moonshine_tpu_torch/csrc/graph_cond.cu",
                 "moonshine_tpu/integrator/path.py:706 _bounce_shrunk's "
                 "lax.cond and :802 trace_paths' while_loop cond (XLA "
                 "control flow, no pallas_call)"),
    "graph_tail": ("moonshine_tpu_torch/csrc/graph_cond.cu",
                   "moonshine_tpu/integrator/path.py:816 trace_paths' "
                   "while_loop body's bounce + 1 and :802 its cond (XLA "
                   "control flow, no pallas_call)"),
    "raygen": ("moonshine_tpu_torch/csrc/frame.cu",
               "moonshine_tpu/render/renderer.py:126 _sample_rays and :141 "
               "_sample_rays_batched with integrator/path.py:655 "
               "_init_state (jnp, no pallas_call)"),
    "accumulate": ("moonshine_tpu_torch/csrc/frame.cu",
                   "moonshine_tpu/render/renderer.py:158 _staged_accum with "
                   "integrator/path.py:731 _staged_finish's scatter by pix "
                   "(jnp, no pallas_call)"),
    "counts": ("moonshine_tpu_torch/csrc/shade.cu",
               "moonshine_tpu/integrator/path.py:400 jnp.sum(active), :580 "
               "jnp.sum(lane) and :687 the live count (jnp, no "
               "pallas_call)"),
}
# the __global__ functions each wrapper of the kernels line launches
CUDA_KERNELS = {
    "closest_hit": ["traverse_kernel"], "any_hit": ["traverse_kernel"],
    "treelet_closest_hit": ["treelet_kernel"],
    "treelet_any_hit": ["treelet_kernel"],
    "treelet_pending": ["pending_kernel"],
    "v_closest_hit": ["traverse_kernel"], "v_any_hit": ["traverse_kernel"],
    "vpu_slab": ["slab_kernel"], "vpu_alu": ["alu_kernel"],
    "bitcast": ["bitcast_kernel"], "tlas_closest_hit": ["tlas_kernel"],
    "tlas_any_hit": ["tlas_kernel"], "surface": ["surface_kernel"],
    "scatter": ["scatter_kernel"], "env_miss": ["env_miss_kernel"],
    "env_draw": ["env_draw_kernel"],
    "sort_lanes": ["radix_upsweep_kernel", "radix_onesweep_kernel",
                   "lane_move_kernel"],
    "unsort_lanes": ["lane_move_kernel"],
    "graph_if": ["set_case_kernel"], "graph_tail": ["tail_kernel"],
    "raygen": ["raygen_kernel"],
    "accumulate": ["pix_scatter_kernel", "accumulate_kernel"],
    "counts": ["surface_kernel", "scatter_kernel"],
}
OFFLINE_SPP = 4  # the CLI's default is 16; cut to bound the run's time
ENGINE_HW = (720, 1280)  # the engine phase's frame (the offline CLI's size)
SHARDED_HWS = (512, 512, 2)  # the sharded phase's frame and spp
TREELET_ENV = {"MSN_WIDE": "8", "MSN_LEAF_CAP": "8"}


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
              flush=True)
        raise
    print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def say(name, msg):
    print(f"[{name}] {msg}", flush=True)


def _counted():
    from moonshine_tpu_torch.accel import packet, tlas, treelet
    from moonshine_tpu_torch.core import sortutil
    from moonshine_tpu_torch.integrator import shade
    from moonshine_tpu_torch.render import frame_kernels

    return (packet, treelet, tlas, shade, sortutil, frame_kernels)


def reset_counts():
    """Every kernel wrapper's launch count set to 0."""
    for m in _counted():
        m.reset_launch_counts()


def read_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    return {k: v for m in _counted() for k, v in m.LAUNCHES.items()}


def cuda_ms(fn, reps):
    """Mean device time of fn over `reps` calls after one warm-up call."""
    from moonshine_tpu_torch.scripts import cuda_ms as timer

    return timer(fn, reps)


def host_ms(fn):
    """Host-clock time of one synchronised call of fn, in ms."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def same_image(name, tag, img, ref):
    """Raises unless >= 99% of pixels agree within 1e-3 (abs + rel) and the
    means within 1e-3 relative."""
    pix = (np.abs(img - ref) <= 1e-3 + 1e-3 * np.abs(ref)).all(-1)
    mean_rel = abs(img.mean() / ref.mean() - 1.0)
    say(tag, f"{name}: {pix.mean():.4%} of pixels within 1e-3, mean "
        f"{img.mean():.6f} vs {ref.mean():.6f} (rel {mean_rel:.3g})")
    if pix.mean() < 0.99 or mean_rel > 1e-3 or not np.isfinite(img).all():
        raise AssertionError(f"{name}: images disagree")


def grazing(hit, lanes):
    """Lanes whose hit lies within 1e-4 (barycentric) of a triangle edge."""
    u, v = hit.u[lanes], hit.v[lanes]
    return np.minimum(np.minimum(u, v), 1.0 - u - v) < 1e-4


def test_batch(scene, lens):
    """Camera rays (512x512) plus 100,003 seeded rays inside the scene
    box, 10% dead lanes, and a finite any-hit t_max per lane."""
    import torch

    from moonshine_tpu_torch.render.renderer import _sample_rays

    dev = scene.device
    o_cam, d_cam, _, _ = _sample_rays(lens, 512, 512, 0, True, dev)
    rs = np.random.RandomState(7)
    n_syn = 100_003  # with 262144 camera rays: not a multiple of 128
    lo, hi = (scene.wide.bounds[0].cpu().numpy(),
              scene.wide.bounds[1].cpu().numpy())
    o_syn = (lo + rs.rand(n_syn, 3) * (hi - lo)).astype(np.float32)
    d_syn = rs.randn(n_syn, 3).astype(np.float32)
    d_syn /= np.linalg.norm(d_syn, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.from_numpy(o_syn).to(dev)])
    d = torch.cat([d_cam, torch.from_numpy(d_syn).to(dev)])
    n = o.shape[0]
    active = torch.from_numpy(rs.rand(n) > 0.1).to(dev)
    diag = float(np.linalg.norm(hi - lo))
    t_fin = torch.from_numpy(
        (rs.uniform(0.02, 1.0, n) * diag).astype(np.float32)).to(dev)
    return o, d, active, t_fin


def check_closest(name, hk, hp, active, n, tag="kernels"):
    """Raises unless a kernel's hits agree with the plain ones within the
    bar: is_hit flips only on edge grazes (at most 1e-5 of the rays), t
    within 1e-5 relative, tri differing only on equal t. Returns max|dt|
    over lanes with the same triangle."""
    import torch

    from moonshine_tpu_torch.accel import packet

    torch.cuda.synchronize()
    hk = packet.Hit(*(x.cpu().numpy() for x in hk))
    hp = packet.Hit(*(x.cpu().numpy() for x in hp))
    hit_k, hit_p = hk.tri >= 0, hp.tri >= 0
    if (hit_k[~active.cpu().numpy()]).any():
        raise AssertionError(f"{name}: a dead lane reported a hit")
    miss_dif = np.nonzero(hit_k != hit_p)[0]
    graze_ok = np.where(hit_k[miss_dif], grazing(hk, miss_dif),
                        grazing(hp, miss_dif))
    both = hit_k & hit_p
    rel_t = np.abs(hk.t - hp.t) / np.maximum(np.abs(hp.t), 1e-30)
    tri_dif = np.nonzero(both & (hk.tri != hp.tri))[0]
    same = both & (hk.tri == hp.tri)
    uv_err = max(float(np.abs(hk.u - hp.u)[same].max(initial=0.0)),
                 float(np.abs(hk.v - hp.v)[same].max(initial=0.0)))
    t_err = float(np.abs(hk.t - hp.t)[same].max(initial=0.0))
    ok = (len(miss_dif) <= 1e-5 * n and graze_ok.all()
          and (rel_t[both] <= 1e-5).all() and np.array_equal(
              hk.t[~hit_k & ~hit_p], hp.t[~hit_k & ~hit_p])
          and (rel_t[tri_dif] <= 1e-5).all() and uv_err <= 1e-4)
    say(tag, f"{name}: {n} rays, {int(hit_p.sum())} hits, is_hit "
        f"mismatches {len(miss_dif)} (grazing {int(graze_ok.sum())}), tri "
        f"ties {len(tri_dif)}, max|dt| {t_err:.3g}, max|duv| {uv_err:.3g}")
    if not ok:
        raise AssertionError(f"{name}: closest hits disagree")
    return t_err, hp


def check_any(name, ok_k, ok_p, wbvh, o, d, t_fin, active):
    """Raises unless occlusion agrees but for edge grazes and hits right at
    t_max, judged from the plain closest hit of each disagreeing lane;
    returns max|occluded_k - occluded_p| (0 or 1)."""
    import torch

    from moonshine_tpu_torch.accel import packet

    n = o.shape[0]
    ok_k, ok_p = ok_k.cpu().numpy(), ok_p.cpu().numpy()
    occ_dif = np.nonzero(ok_k != ok_p)[0]
    occ_graze = np.zeros(0, dtype=bool)
    if len(occ_dif):
        idx = torch.from_numpy(occ_dif).to(o.device)
        hp = packet.Hit(*(x.cpu().numpy() for x in packet.closest_hit_plain(
            wbvh, o[idx], d[idx], INF_T, active_in=active[idx])))
        tf = t_fin[idx].cpu().numpy()
        occ_graze = (grazing(hp, np.arange(len(occ_dif)))
                     | (np.abs(hp.t - tf) <= 1e-5 * tf))
    say("kernels", f"{name}: {n} rays, {int(ok_p.sum())} occluded, "
        f"mismatches {len(occ_dif)} (grazing {int(occ_graze.sum())})")
    if len(occ_dif) > 1e-5 * n or not occ_graze.all():
        raise AssertionError(f"{name}: occlusion disagrees")
    return float(len(occ_dif) > 0)


def compare_packet(name, scene, lens, errs):
    from moonshine_tpu_torch.accel import packet

    o, d, active, t_fin = test_batch(scene, lens)
    n = o.shape[0]
    w = scene.wide
    t_err, _ = check_closest(
        f"{name} closest_hit",
        packet.closest_hit_packet(w, o, d, INF_T, active_in=active),
        packet.closest_hit_plain(w, o, d, INF_T, active_in=active), active, n)
    occ_err = check_any(
        f"{name} any_hit (finite t_max)",
        packet.any_hit_packet(w, o, d, t_fin, active_in=active),
        packet.any_hit_plain(w, o, d, t_fin, active_in=active), w, o, d,
        t_fin, active)
    errs["closest_hit"] = max(errs.get("closest_hit", 0.0), t_err)
    errs["any_hit"] = max(errs.get("any_hit", 0.0), occ_err)


def compare_treelet(scene, lens, errs):
    """Treelet phase 1 and the walk against their plain versions bit for
    bit, and the walk against the packet kernel on the same 8-wide tree (t
    and is_hit equal, tri only on equal t; occlusion equal)."""
    import torch

    from moonshine_tpu_torch.accel import packet, treelet

    o, d, active, t_fin = test_batch(scene, lens)
    n = o.shape[0]
    w = scene.wide
    for name, tm in (("1e12", INF_T), ("finite", t_fin)):
        t_eff = torch.where(active, torch.as_tensor(tm, device=o.device),
                            -1e30)
        errs["treelet_pending"] = assert_same(
            f"treelet phase 1 ({name} t_max)",
            treelet._pending_masks(w, o, d, t_eff),
            treelet._pending_masks_plain(w, o, d, t_eff))
    say("kernels", f"room_184k/treelet treelet_pending on {n} rays, 1e12 and "
        f"finite t_max: kernel = plain bit for bit (words, nearest)")
    hk = treelet.closest_hit_treelet(w, o, d, INF_T, active_in=active)
    hp = treelet.closest_hit_treelet_plain(w, o, d, INF_T, active_in=active)
    t_err, _ = check_closest("room_184k/treelet treelet_closest_hit", hk, hp,
                             active, n)
    assert_same("room_184k/treelet treelet_closest_hit", hk, hp)
    pk = packet.closest_hit_packet(w, o, d, INF_T, active_in=active)
    same_t = bool(torch.equal(hk.t, pk.t))
    same_hit = bool(torch.equal(hk.tri >= 0, pk.tri >= 0))
    tie_ok = bool(torch.equal(hk.t[hk.tri != pk.tri], pk.t[hk.tri != pk.tri]))
    say("kernels", f"room_184k/treelet treelet vs packet kernel: t equal "
        f"{same_t}, is_hit equal {same_hit}, tri differs on "
        f"{int((hk.tri != pk.tri).sum())} lanes, all at equal t {tie_ok}")
    if not (same_t and same_hit and tie_ok):
        raise AssertionError("treelet and packet kernels disagree")
    ok_k = treelet.any_hit_treelet(w, o, d, t_fin, active_in=active)
    ok_p = treelet.any_hit_treelet_plain(w, o, d, t_fin, active_in=active)
    occ_err = check_any("room_184k/treelet treelet_any_hit (finite t_max)",
                        ok_k, ok_p, w, o, d, t_fin, active)
    assert_same("room_184k/treelet treelet_any_hit", ok_k, ok_p)
    say("kernels", "room_184k/treelet walk = plain bit for bit (t, tri, u, "
        "v; occlusion)")
    pa = packet.any_hit_packet(w, o, d, t_fin, active_in=active)
    say("kernels", f"room_184k/treelet treelet vs packet any hit: "
        f"{int((ok_k != pa).sum())} mismatches")
    if not torch.equal(ok_k, pa):
        raise AssertionError("treelet and packet any hit disagree")
    errs["treelet_closest_hit"] = t_err
    errs["treelet_any_hit"] = occ_err


def render_1080p(name, scene, lens, cfg, resort, spp=2):
    """Warm-up sample, then spp samples of the 1080p frame through
    render_spp, which must take the staged path with the resort as given
    (the reference resorts HBM-class scenes, not treelet-scheduled ones,
    which sort inside each dispatch); returns (image, stats, launches)."""
    import torch

    from moonshine_tpu_torch.render.renderer import render_spp

    h, w = HD
    render_spp(scene, lens, h, w, 100, 1, cfg)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    reset_counts()
    t0 = time.perf_counter()
    acc, rays = render_spp(scene, lens, h, w, 0, spp, cfg, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    rays = int(rays)
    img = (acc / spp).cpu().numpy()
    say(name, f"{w}x{h} x {spp} spp: {rays} rays in {dt:.4f} s = "
        f"{rays / dt / 1e6:.3f} Mrays/s, {dt / spp * 1e3:.2f} ms/spp, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
        f"path {stats['path']}, resort {stats['resort']}, segments "
        f"{stats['segments']}, launches {launches}, image mean "
        f"{img.mean():.6f}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{name}: non-finite pixels")
    if stats["path"] != "staged" or stats["resort"] != resort:
        raise AssertionError(f"{name}: expected the staged path with "
                             f"resort {resort}, got {stats}")
    return img, stats, launches


def bound(name, n, visits, wbvh, k32=0, record_bytes=None):
    """(bound_ms, bound_by, detail) for one kernel call on n rays that
    touched `visits` (the plain version's count on the same rays); each
    distinct record read counts `record_bytes` (node, leaf), by default
    the whole row."""
    from moonshine_tpu_torch.accel import packet

    closest = "closest" in name
    ray_in = 12 + 12 + 4 + (4 + 4 * k32 if k32 else 1)  # o, d, t_max, mask
    ray_out = 16 if closest else 1
    row = lambda x: x[0].numel() * x.element_size()
    node_b, leaf_b = record_bytes or (row(wbvh.nodes), row(wbvh.leaves))
    nbytes = (n * (ray_in + ray_out) + visits.node_rows * node_b
              + visits.leaf_rows * leaf_b)
    flops = (visits.node_slots * packet.FLOPS_PER_NODE_SLOT
             + visits.leaf_tris * (packet.FLOPS_PER_TRI_CLOSEST if closest
                                   else packet.FLOPS_PER_TRI_ANY))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, (
        f"{visits.nodes} node visits ({visits.node_slots} slots), "
        f"{visits.leaves} leaf visits ({visits.leaf_tris} triangles), "
        f"{visits.node_rows}+{visits.leaf_rows} distinct rows; "
        f"{nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.3f} "
        f"GFLOP -> {t_ops:.4f} ms")


def phase1_bytes(n, k):
    """Bytes that `treelet._pending_masks_plain` moves for n rays and k
    treelets, counted from its tensor ops on [chunk, 32] temporaries (each
    read and each write once, per-ray terms left out; a 1M-lane chunk's
    tensors exceed L2): per axis two slabs (a subtract and a multiply, 12
    B each) and a min and a max (12 B each), on axes 1-2 also the running
    max and min (12 B each): 192 B; the hit mask 27 B, the bit-word sum 17
    B, the entry t 17 B, its amin and argmin 8 B."""
    return n * k * 261


def time_pending(wb, o, d, t_eff, label):
    """Treelet phase 1 on one launch's lanes: the kernel against its torch
    version bit for bit, both timed; two bounds
    (compare_treelet.pending_bounds), each counting each ray's o, d and
    t_max read and its words and nearest treelet written once and the
    boxes read once: the row's, every live (ray, treelet) pair's box test
    (packet.FLOPS_PER_NODE_SLOT) plus an entry max and compare per
    pending pair, and the culled work's, a union test per live ray and
    word and a box test per treelet of each word the ray enters, plus
    the same per pending pair. Returns the timings entry (the all-pairs
    bound)."""
    from moonshine_tpu_torch.accel import treelet
    from moonshine_tpu_torch.scripts.compare_treelet import pending_bounds

    got = treelet._pending_masks(wb, o, d, t_eff)
    want = treelet._pending_masks_plain(wb, o, d, t_eff)
    assert_same(f"treelet_pending on {label}", got, want)
    b = pending_bounds(wb, o, d, t_eff, got[0], PEAK_BYTES, PEAK_FP32)
    ms = cuda_ms(lambda: treelet._pending_masks(wb, o, d, t_eff), 20)
    plain_ms = cuda_ms(lambda: treelet._pending_masks_plain(wb, o, d, t_eff),
                       3)
    m, k = o.shape[0], b["k"]
    nb = phase1_bytes(m, k)
    (bound, by), (culled, culled_by) = b["all_pairs"], b["culled"]
    say("timings", f"treelet_pending on {label}: kernel = plain bit for bit "
        f"(words, nearest); kernel {ms:.4f} ms, torch version {plain_ms:.2f} "
        f"ms (moving ~{nb / 1e9:.2f} GB by its tensor ops = "
        f"{nb / plain_ms / 1e9:.3f} TB/s); all-pairs bound {bound:.4f} ms "
        f"by {by} ({b['live']} live of {m} lanes x K {k}, {b['pairs']} "
        f"pending pairs; {b['bytes'] / 1e6:.2f} MB, "
        f"{b['all_pairs_flops'] / 1e9:.3f} GFLOP), culled bound "
        f"{culled:.4f} ms by {culled_by} ({b['entered_words']} words "
        f"entered, {b['culled_flops'] / 1e9:.3f} GFLOP); kernel at "
        f"{bound / ms:.1%} of the all-pairs bound, {culled / ms:.1%} of the "
        f"culled one; no single PyTorch call does it, so no library time")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                culled_bound_ms=culled)


def time_kernels(scenes, timings, errs):
    """Each kernel at the largest shape the 1080p main path gives it:
    closest hit on the frame's 2,073,600 camera rays, any hit on their
    4,147,200-lane shadow batch. The kernel alone on the inputs it gets
    (treelet kernels on phase-1 sorted lanes) is timed and held against its
    plain version on the same inputs, whose visit counts also bound it;
    the packet kernels also bit for bit, and in three alternated rounds
    against the format-V kernels on the same rays. Any hit is held again
    on the batch's mesh-light half (2,073,600 lanes, the shadow batch of a
    half-width live-prefix bounce)."""
    import torch

    from moonshine_tpu_torch.accel import native, packet, treelet, vpacket
    from moonshine_tpu_torch.core import sortutil
    from moonshine_tpu_torch.render.renderer import _sample_rays
    from moonshine_tpu_torch.scripts import shadow_batch

    h, w = HD
    for tree in ("default", "treelet"):
        scene, lens = scenes[f"room_184k/{tree}"]
        wb = scene.wide
        o, d, _, _ = _sample_rays(lens, h, w, 0, True, scene.device)
        n = o.shape[0]
        if tree == "default":
            layout = packet.kernel_layout(wb)
            lib = native.traverse_lib()
            kernel_bytes = lib.shared_bytes(
                layout.top_rows, wb.nodes[0].numel(), layout.stack_depth)
            g = lib.group_lanes(wb.width)
            say("timings", f"packet kernels on the {wb.width}/"
                f"{wb.leaf_slots} tree: G = {g} lanes a ray, blocks of "
                f"{packet.GROUPS_PER_BLOCK} groups ({packet.GROUPS_PER_BLOCK * g}"
                f" threads), R = {layout.top_rows} top rows in shared "
                f"memory, stacks of "
                f"{layout.stack_depth} entries, {layout.shared_bytes} B of "
                f"shared memory a block (the kernel counts {kernel_bytes})")
            if kernel_bytes != layout.shared_bytes:
                raise AssertionError("kernel_layout and the kernel count "
                                     "shared memory differently")
            v = vpacket.v_from_wide(wb)
        batches = {
            "closest_hit": (o, d, torch.full((n,), INF_T, device=o.device),
                            torch.ones(n, dtype=torch.bool, device=o.device),
                            False),
            "any_hit": (*shadow_batch(o, d, packet.closest_hit_packet(
                wb, o, d, INF_T)), True),
        }
        for base, (ro, rd, tm, act, any_hit) in batches.items():
            m = ro.shape[0]
            if tree == "default":
                kname, k32 = base, 0
                fk = packet.any_hit_packet if any_hit else \
                    packet.closest_hit_packet
                fp = packet.any_hit_plain if any_hit else \
                    packet.closest_hit_plain
                lanes = (ro, rd, tm, act)
                kern = lambda: fk(wb, ro, rd, tm, act)
                plain = lambda c=False: fp(wb, ro, rd, tm, act,
                                           count_visits=c)
                unsort = lambda x: x
            else:
                kname = f"treelet_{base}"
                t_eff = torch.where(act, tm, -1e30)
                p1 = time_pending(wb, ro, rd, t_eff, f"{m} {base} lanes")
                if not any_hit:  # the JSON line's: 2,073,600 camera rays
                    timings["treelet_pending"] = p1
                perm, srt = treelet._sort_lanes(wb, ro, rd, t_eff)
                k32 = srt[3].shape[1]
                lanes = (*srt[:3], srt[2] > 0.0)
                kern = lambda a=srt, ah=any_hit: treelet._dispatch_kernel(
                    wb, *a, ah)
                plain = lambda c=False, a=srt, ah=any_hit: \
                    treelet._dispatch_plain(wb, *a, ah, count_visits=c)
                unsort = lambda x, p=perm: sortutil.unsort_lanes_plain(
                    p, [x])[0]
                fk = treelet.any_hit_treelet if any_hit else \
                    treelet.closest_hit_treelet
                ms_wrap = cuda_ms(lambda: fk(wb, ro, rd, tm, act), 5)
                say("timings", f"{kname} on {m} rays: whole wrapper "
                    f"(phase 1, sort, walk, unsort) {ms_wrap:.4f} ms, phase "
                    f"1 {p1['ms']:.4f} ms of it; the walk: blocks of "
                    f"{native.treelet_lib().block(wb.treelet_stack)} "
                    f"threads, stacks of {wb.treelet_stack} entries (the "
                    f"tree's bound {wb.max_stack})")
                if not any_hit:  # the schedule against the packet kernel
                    runs = {"treelet kernel": lambda a=srt: (
                                treelet._dispatch_kernel(wb, *a, False)),
                            "packet kernel, the same sorted lanes":
                                lambda a=lanes: packet.closest_hit_packet(
                                    wb, *a),
                            "packet kernel, camera order": lambda: (
                                packet.closest_hit_packet(wb, ro, rd, tm,
                                                          act))}
                    ms_runs = {k: [] for k in runs}
                    for _ in range(3):  # alternated, so clocks hit all alike
                        for k, fn in runs.items():
                            ms_runs[k].append(cuda_ms(fn, 5))
                    say("timings", "closest hit on the same 8/8 tree, three "
                        "alternated rounds: " + "; ".join(
                            f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                            + " ms" for k, v in ms_runs.items()))
            if tree == "default":  # the packet kernel against format V
                vk = (vpacket.any_hit_vpacket if any_hit
                      else vpacket.closest_hit_vpacket)
                runs = {"packet kernel": kern,
                        "V kernel": lambda a=lanes, f=vk:
                            f(v, *a)}
                ms_runs = {k: [] for k in runs}
                for _ in range(3):  # alternated, so clocks hit both alike
                    for k, fn in runs.items():
                        ms_runs[k].append(cuda_ms(fn, 5))
                say("timings", f"{kname} on {m} lanes, the same {wb.width}/"
                    f"{wb.leaf_slots} rays, three alternated rounds: "
                    + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in xs)
                                + " ms" for k, xs in ms_runs.items()))
            ms = cuda_ms(kern, 5)
            out_k = kern()
            out_p, visits = plain(True)  # also the plain version's warm-up
            plain_ms = host_ms(plain)
            assert_same(f"{kname} on {m} lanes", out_k, out_p)
            say("timings", f"{kname} on {m} lanes: kernel = plain bit for "
                f"bit (" + ("occlusion" if any_hit else "t, tri, u, v")
                + ")" + (f"; {visits.roots_skipped} root visits skipped "
                         f"({visits.roots_skipped / m:.4f} a lane)"
                         if tree == "treelet" else ""))
            if any_hit:
                err = check_any(f"{kname} (timed batch)", out_k, out_p, wb,
                                *lanes)
                half = slice(m // 2, m)
                err = max(err, check_any(
                    f"{kname} (the batch's mesh-light half)",
                    fk(wb, ro[half], rd[half], tm[half], act[half]),
                    unsort(out_p)[half], wb, ro[half], rd[half], tm[half],
                    act[half]))
            else:
                err, _ = check_closest(f"{kname} (timed batch)", out_k,
                                       out_p, lanes[3], m)
            errs[kname] = max(errs[kname], err)
            b_ms, b_by, detail = bound(kname, m, visits, wb, k32)
            timings[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by)
            say("timings", f"{kname} on {m} rays ({tree} tree): kernel "
                f"{ms:.4f} ms, plain torch {plain_ms:.2f} ms, bound "
                f"{b_ms:.4f} ms by {b_by} ({detail}); no single PyTorch "
                f"call traverses a BVH, so no library time")
        if tree == "treelet":  # phase 1 at a deep bounce's launch too
            from moonshine_tpu_torch.integrator.path import PathConfig
            from moonshine_tpu_torch.scripts import compare_treelet

            cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                             mesh_samples_per_bounce=1)
            _, do, dd, dt = compare_treelet.deep_launch(
                compare_treelet.record_launches(scene, lens, cfg))
            deep = time_pending(wb, do, dd, dt, f"{do.shape[0]} lanes of "
                                "treelet_1080p's bounce-3 closest hit")
            timings["treelet_pending"]["deep_ms"] = deep["ms"]


def assert_same(name, got, *wants):
    """Raises unless `got` (a Hit or a bool tensor) equals each of `wants`
    bit for bit; returns max|t| or max|occlusion| difference (0.0)."""
    import torch

    torch.cuda.synchronize()
    as_tuple = lambda x: tuple(x) if isinstance(x, tuple) else (x,)
    for want in wants:
        for g, w in zip(as_tuple(got), as_tuple(want)):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: {int((g != w).sum())} lanes "
                                     f"differ")
    return 0.0


def vpacket_phase(scenes, timings, errs, launches):
    """Format V on both room_184k trees: the kernels against their plain
    versions and the packet kernel (the test batch, then the 1080p main
    path's largest launches, timed alternately with the packet kernel),
    then the row-versus-V entry point, whose launches are counted."""
    import torch

    from moonshine_tpu_torch.accel import native, packet, vpacket
    from moonshine_tpu_torch.render.renderer import _sample_rays
    from moonshine_tpu_torch.scripts import profile_vpacket, shadow_batch

    h, w = HD
    lib = native.vpacket_lib()
    for tree in ("default", "treelet"):
        scene, lens = scenes[f"room_184k/{tree}"]
        wb = scene.wide
        t0 = time.perf_counter()
        v = vpacket.v_from_wide(wb)
        torch.cuda.synchronize()
        tb, rb = vpacket.tile_bytes(v), packet.row_bytes(wb)
        layout = vpacket.kernel_layout(v)
        kernel_bytes = lib.shared_bytes(layout.top_rows, v.nodes[0].numel(),
                                        layout.stack_depth)
        g = lib.group_lanes(wb.width)
        say("vpacket", f"room_184k/{tree} ({wb.width}/{wb.leaf_slots}): "
            f"{wb.num_nodes} + {wb.num_leaves} tiles = {tb} B, "
            f"{tb / rb:.2f}x the rows' {rb} B; tiled in "
            f"{time.perf_counter() - t0:.2f} s; V kernels: G = {g} lanes a "
            f"ray, blocks of {packet.GROUPS_PER_BLOCK * g} threads, "
            f"{layout.top_rows} top tiles and stacks of "
            f"{layout.stack_depth} entries in shared memory, "
            f"{layout.shared_bytes} B a block (the kernel counts "
            f"{kernel_bytes})")
        if kernel_bytes != layout.shared_bytes:
            raise AssertionError("vpacket.kernel_layout and the V kernel "
                                 "count shared memory differently")
        o, d, active, t_fin = test_batch(scene, lens)
        args = (o, d, INF_T, active)
        assert_same(f"{tree} test batch closest hit",
                    vpacket.closest_hit_vpacket(v, *args),
                    vpacket.closest_hit_plain(v, *args),
                    packet.closest_hit_packet(wb, *args))
        args = (o, d, t_fin, active)
        assert_same(f"{tree} test batch any hit",
                    vpacket.any_hit_vpacket(v, *args),
                    vpacket.any_hit_plain(v, *args),
                    packet.any_hit_packet(wb, *args))
        say("vpacket", f"room_184k/{tree} test batch ({o.shape[0]} rays): "
            f"V kernels = V plain = packet kernel, closest and any hit, "
            f"bit for bit")
        o, d, _, _ = _sample_rays(lens, h, w, 0, True, scene.device)
        n = o.shape[0]
        batches = {
            "v_closest_hit": (o, d, torch.full((n,), INF_T, device=o.device),
                              torch.ones(n, dtype=torch.bool,
                                         device=o.device)),
            "v_any_hit": shadow_batch(o, d, packet.closest_hit_packet(
                wb, o, d, INF_T)),
        }
        node_f, leaf_f = vpacket.used_floats(v)
        for kname, lanes in batches.items():
            m = lanes[0].shape[0]
            if kname == "v_any_hit":
                kern = lambda a=lanes: vpacket.any_hit_vpacket(v, *a)
                pk = lambda a=lanes: packet.any_hit_packet(wb, *a)
                plain = lambda c=False, a=lanes: vpacket.any_hit_plain(
                    v, *a, count_visits=c)
            else:
                kern = lambda a=lanes: vpacket.closest_hit_vpacket(v, *a)
                pk = lambda a=lanes: packet.closest_hit_packet(wb, *a)
                plain = lambda c=False, a=lanes: vpacket.closest_hit_plain(
                    v, *a, count_visits=c)
            out_p, visits = plain(True)
            err = assert_same(f"{tree} {kname} on {m} lanes", kern(), out_p,
                              pk())
            plain_ms = host_ms(plain)
            rounds = {"V kernel": [], "packet kernel": []}
            for _ in range(3):  # alternated, so clocks hit both alike
                rounds["V kernel"].append(cuda_ms(kern, 5))
                rounds["packet kernel"].append(cuda_ms(pk, 5))
            ms = sum(rounds["V kernel"]) / 3
            b_ms, b_by, detail = bound(kname, m, visits, v,
                                       record_bytes=(4 * node_f, 4 * leaf_f))
            rb_ms, rb_by, _ = bound(kname, m, visits, wb)
            say("vpacket", f"{kname} on {m} lanes ({tree} tree): V kernel = V "
                f"plain = packet kernel bit for bit; three alternated "
                f"rounds: " + "; ".join(
                    f"{k} " + " / ".join(f"{x:.4f}" for x in xs) + " ms"
                    for k, xs in rounds.items())
                + f"; V plain {plain_ms:.2f} ms; bound {b_ms:.4f} ms by "
                f"{b_by} ({detail}); the packet kernel's bound on the same "
                f"visits {rb_ms:.4f} ms by {rb_by}")
            if tree == "default":
                errs[kname] = err
                timings[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by)

    # the slice's entry point: counts set to 0 just before, read just after
    scene, lens = scenes["room_184k/default"]
    vpacket.reset_launch_counts()
    profile_vpacket.bench_scene("room_184k", scene, lens, count_visits=True)
    launches.update(vpacket.LAUNCHES)
    say("vpacket", f"profile_vpacket launches {dict(vpacket.LAUNCHES)}")
    if min(vpacket.LAUNCHES.values()) == 0:
        raise AssertionError("the row-versus-V run launched no V kernel")


def fallback_phase(scenes, cfg):
    """The dispatch forced into the per-lane walk (the reference's jnp
    fallback): a stack limit of 1 on an HBM-class scene."""
    import torch

    from moonshine_tpu_torch.accel import packet, traverse
    from moonshine_tpu_torch.integrator import path
    from moonshine_tpu_torch.render.renderer import _sample_rays, render_spp

    scene, lens = scenes["flagship"]
    want, _ = render_spp(scene, lens, 256, 256, 0, 1, cfg)
    want = want.cpu().numpy()
    saved = packet.HBM_STACK_DEPTH, packet.VMEM_SCENE_BUDGET_BYTES
    packet.HBM_STACK_DEPTH, packet.VMEM_SCENE_BUDGET_BYTES = 1, 0
    try:
        mode = path._hbm_mode(scene.wide)
        traverse.reset_call_counts()
        packet.reset_launch_counts()
        stats = {}
        t0 = time.perf_counter()
        got, rays = render_spp(scene, lens, 256, 256, 0, 1, cfg, stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        calls, pk = dict(traverse.CALLS), dict(packet.LAUNCHES)
    finally:
        packet.HBM_STACK_DEPTH, packet.VMEM_SCENE_BUDGET_BYTES = saved
    say("fallback", f"flagship 256x256 x 1 spp in mode {mode}: {int(rays)} "
        f"rays in {dt:.3f} s, walk calls {calls}, packet launches {pk}, "
        f"resort {stats['resort']}")
    if (mode != "lanes" or calls["closest_hit"] != stats["segments"]
            or calls["any_hit"] == 0 or any(pk.values())):
        raise AssertionError("the forced render did not take the walk")
    same_image("the per-lane walk's render against the default path",
               "fallback", got.cpu().numpy(), want)
    o, d, _, _ = _sample_rays(lens, 512, 512, 0, True, scene.device)
    n = o.shape[0]
    hk = packet.closest_hit_packet(scene.wide, o, d, INF_T)
    hl = None

    def walk():
        nonlocal hl
        hl = traverse.closest_hit(scene.bvh, scene.tri_verts_sorted, o, d,
                                  INF_T)
    ms = host_ms(walk)
    ones = torch.ones(n, dtype=torch.bool, device=o.device)
    check_closest("per-lane walk vs packet kernel", hl, hk, ones, n,
                  tag="fallback")
    pk_ms = cuda_ms(lambda: packet.closest_hit_packet(scene.wide, o, d,
                                                      INF_T), 5)
    say("fallback", f"traverse.closest_hit on {n} flagship camera rays: "
        f"{ms:.2f} ms in torch ops (the packet kernel: {pk_ms:.4f} ms)")


def vpu_bounds(kind, dtype, lanes, visits):
    """(bound_ms, bound_by) of one slab or ALU launch: its inputs read and
    its output written once against its operations at the dtype's peak
    outside the tensor cores (25 per child test and lane, 3 of them
    float32 compares; 12 per ALU iteration and lane, the chain's two
    loop-invariant products once)."""
    import torch

    size = 2 if dtype == torch.bfloat16 else 4
    peak = PEAK_BF16_VECTOR if dtype == torch.bfloat16 else PEAK_FP32
    if kind == "slab":
        nbytes = 128 * 128 * 4 + 6 * lanes * size + 4
        t_ops = visits * 8 * lanes * (22 / peak + 3 / PEAK_FP32)
    else:
        nbytes = 3 * lanes * size
        t_ops = (visits * 12 + 2) * lanes / peak
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def vpu_phase(dev, timings, errs, launches):
    """The slab and ALU kernels against their plain versions: every
    configuration at 1, 20, 127 and 129 visits (either side of a chunk's
    edge and of the v % 128 wrap) on the reference's inputs and seeded
    ones (where lanes hit), then at 2000 visits on both; the latency probe
    and the ALU chain's floor, an empty kernel; the entry point at 2000
    visits with its launches counted."""
    import torch

    from moonshine_tpu_torch.scripts import profile_vpu as V

    def check(seed, visits, nonzero):
        tag = f"{'seeded' if seed else 'reference'} inputs, {visits} visits"
        counts = []
        for name, dt, fma_form, packed in V.SLAB_CONFIGS:
            rows, planes = V.slab_inputs(dt, dev, seed=seed)
            k = int(V.slab(rows, planes, fma_form, packed, visits))
            p = int(V.slab_plain(rows, planes, fma_form, packed, visits))
            counts.append(f"{k}/{p}")
            if k != p or (nonzero and k == 0):
                raise AssertionError(f"{name}, {tag}: slab counts disagree "
                                     f"({k} against {p}) or no lane hit")
        for name, dt, r in V.ALU_CONFIGS:
            a, b = V.alu_inputs(dt, r, dev, seed=seed)
            if not torch.equal(V.alu(a, b, visits), V.alu_plain(a, b, visits)):
                raise AssertionError(f"{name}, {tag}: ALU outputs differ")
        say("vpu", f"{tag}: slab counts kernel/plain {' '.join(counts)}; "
            f"ALU kernel = plain bit for bit in all four")

    for visits in (1, 20, 127, 129):
        for seed in (None, V.SEED):
            check(seed, visits, nonzero=seed is not None and visits >= 20)
    # every configuration at 2000 visits on both inputs (seeded: lanes
    # hit); the kernels line takes the first of each kind on the
    # reference's inputs, the ones the entry point times, for its error
    # and plain time as for its kernel time
    out = {}
    for seed in (V.SEED, None):
        inputs = "seeded" if seed else "reference"
        for i, (name, dt, fma_form, packed) in enumerate(V.SLAB_CONFIGS):
            rows, planes = V.slab_inputs(dt, dev, seed=seed)
            plain_ms = host_ms(lambda: out.update(p=V.slab_plain(
                rows, planes, fma_form, packed)))
            k = int(V.slab(rows, planes, fma_form, packed))
            say("vpu", f"{name}, {inputs} inputs, {V.VISITS} visits: "
                f"kernel {k}, plain {int(out['p'])} ({plain_ms:.2f} ms)")
            if k != int(out["p"]) or (seed and k == 0):
                raise AssertionError(f"{name}, {inputs} inputs: slab counts "
                                     f"disagree at {V.VISITS} visits or no "
                                     f"lane hit")
            if i == 0 and seed is None:
                errs["vpu_slab"] = float(abs(k - int(out["p"])))
                timings["vpu_slab"] = dict(plain_ms=plain_ms)
        for i, (name, dt, r) in enumerate(V.ALU_CONFIGS):
            a, b = V.alu_inputs(dt, r, dev, seed=seed)
            plain_ms = host_ms(lambda: out.update(a=V.alu_plain(a, b)))
            got = V.alu(a, b)
            if not torch.equal(got, out["a"]):
                raise AssertionError(f"{name}, {inputs} inputs: ALU outputs "
                                     f"differ at {V.VISITS} visits")
            if i == 0 and seed is None:
                errs["vpu_alu"] = float((got - out["a"]).abs().max())
                timings["vpu_alu"] = dict(plain_ms=plain_ms)
    say("vpu", f"{V.VISITS} visits: all five slab counts equal the plain "
        f"versions' and all four ALU chains bit for bit, on the reference's "
        f"inputs and on seeded ones")
    # floors beside the roofline bounds: the chain's latency and a launch
    lat, hz = V.latencies(dev)
    for kind in V.KINDS:
        say("vpu", f"latency {kind}: " + ", ".join(
            f"{op} {lat[kind][op]:.3f}" for op in V.OPS)
            + " cycles a dependent op")
    floors = {dt: V.chain_floor_ms(lat[kind], hz)
              for dt, kind in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16"))}
    floor_x2 = V.chain_floor_ms(lat["bf16x2"], hz)
    empty = V.empty_ms(dev)
    # the chain itself on one warp: 32 elements, nothing to share an SM with
    warp = {}
    for dt in (torch.float32, torch.bfloat16):
        a, b = (x[:, :32].contiguous() for x in V.alu_inputs(dt, 1, dev))
        warp[dt] = cuda_ms(lambda: V.alu(a, b), 5)
    say("vpu", f"SM clock {hz / 1e9:.4f} GHz (probe cycles over event "
        f"time); ALU chain floor at {V.VISITS} visits: f32 "
        f"{floors[torch.float32]:.4f} ms, bf16 {floors[torch.bfloat16]:.4f} "
        f"ms (bf16x2 ops {floor_x2:.4f} ms); the ALU kernel on one warp "
        f"(32 elements): f32 {warp[torch.float32]:.4f} ms, bf16 "
        f"{warp[torch.bfloat16]:.4f} ms; empty kernel {empty:.4f} ms")
    V.reset_launch_counts()
    ms = V.main()  # the entry point: counts set to 0 just before
    launches.update(V.LAUNCHES)
    say("vpu", f"profile_vpu launches {dict(V.LAUNCHES)}")
    if min(V.LAUNCHES.values()) == 0:
        raise AssertionError("profile_vpu launched no kernel")
    for name, dt, fma_form, packed in V.SLAB_CONFIGS:
        say("vpu", f"{name}: {ms[name]:.4f} ms, bound %.4f ms by %s; "
            f"floor: empty kernel {empty:.4f} ms" % vpu_bounds(
                "slab", dt, V.ROWS * 128, V.VISITS))
    for name, dt, r in V.ALU_CONFIGS:
        say("vpu", f"{name}: {ms[name]:.4f} ms, bound %.4f ms by %s; "
            f"floors: chain {floors[dt]:.4f} ms, empty kernel {empty:.4f} "
            f"ms" % vpu_bounds("alu", dt, r * 128, V.VISITS))
    for key, (name, dt, lanes) in (
            ("vpu_slab", (V.SLAB_CONFIGS[0][0], V.SLAB_CONFIGS[0][1],
                          V.ROWS * 128)),
            ("vpu_alu", (V.ALU_CONFIGS[0][0], V.ALU_CONFIGS[0][1],
                         V.ALU_CONFIGS[0][2] * 128))):
        b_ms, b_by = vpu_bounds(key[4:], dt, lanes, V.VISITS)
        timings[key].update(ms=ms[name], bound_ms=b_ms, bound_by=b_by)
        say("vpu", f"{key} at {V.VISITS} visits, reference inputs: kernel "
            f"{timings[key]['ms']:.4f} ms, plain {timings[key]['plain_ms']:.2f}"
            f" ms, max|kernel - plain| {errs[key]}")
    if errs["vpu_slab"] or errs["vpu_alu"]:
        raise AssertionError("a VPU kernel disagrees at 2000 visits")


def bitcast_phase(dev, timings, errs, launches):
    """Kernel 8 against its plain version bit for bit at the six row
    widths (the reference's rows, and seeded ones whose words exceed 2^24
    so the conversions round); the probe's entry point in-process with
    its launches counted and as a module; then the kernel timed at each
    width, its bound the bytes of one row in and 2 KB out."""
    import torch

    from moonshine_tpu_torch.scripts import probe_bitcast as B

    err = 0.0
    for rowlen in B.ROWLENS:
        for rows in (B.reference_rows(rowlen, dev),
                     B.seeded_rows(rowlen, rowlen, dev)):
            got, want = B.decode_rows(rows), B.decode_rows_plain(rows)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"bitcast rowlen {rowlen}: kernel and "
                                     f"plain version differ")
    errs["bitcast"] = err
    say("bitcast", f"kernel = plain bit for bit at rowlens {B.ROWLENS}, "
        f"the reference's rows and seeded rows")
    # the probe's path: counts set to 0 just before, read just after
    B.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = B.main()
    launches["bitcast"] = B.LAUNCHES["bitcast"]
    lines = buf.getvalue().splitlines()
    for ln in lines:
        say("bitcast", f"probe: {ln}")
    if rc != 0 or lines[-1] != "overall: PASS" or launches["bitcast"] != len(
            B.ROWLENS):
        raise AssertionError(f"the probe failed or launched "
                             f"{launches['bitcast']} kernels")
    proc = subprocess.run(
        [sys.executable, "-m", "moonshine_tpu_torch.scripts.probe_bitcast"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    say("bitcast", f"python -m moonshine_tpu_torch.scripts.probe_bitcast: "
        f"exit {proc.returncode}, last line {proc.stdout.strip()[-40:]!r}")
    if proc.returncode != 0 or not proc.stdout.strip().endswith(
            "overall: PASS"):
        raise AssertionError(f"the probe module failed:\n{proc.stdout}"
                             f"\n{proc.stderr}")
    for rowlen in B.ROWLENS:
        rows = B.seeded_rows(rowlen, rowlen, dev)
        ms = cuda_ms(lambda r=rows: B.decode_rows(r), 200)
        plain_ms = host_ms(lambda r=rows: B.decode_rows_plain(r))
        nbytes = 4 * rowlen + 4 * 4 * B.OUT_COLS
        b_ms = nbytes / PEAK_BYTES * 1e3
        say("bitcast", f"rowlen {rowlen}: kernel {ms:.4f} ms, plain torch "
            f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms by bytes ({nbytes} B: "
            f"row 1 in, [4, 128] f32 out; a handful of operations); no "
            f"PyTorch call decodes the row, so no library time")
        timings["bitcast"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by="bytes")


def presplit_phase(scenes, errs, cfg, dev):
    """room_184k built under MSN_PRESPLIT=1.35 against the default build:
    size, the packet kernels against their plain versions on it, visits
    and kernel times at the 1080p launches, and a 512x512 x 2 spp
    render."""
    import torch

    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.integrator import path
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import _sample_rays, render_spp
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scripts import shadow_batch

    base, lens = scenes["room_184k/default"]
    t0 = time.perf_counter()
    with env(MSN_PRESPLIT="1.35"):
        world, _ = procedural.room_scene(grid=6, subdivisions=4)
        scene = world.build(dev, builder="sah")  # "auto" picks it too
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    wb, w0 = scene.wide, base.wide
    n_refs, n_tris = scene.tri_verts_sorted.shape[0], scene.num_tris
    say("presplit", f"room_184k presplit: {n_tris} triangles -> {n_refs} "
        f"references ({n_refs / n_tris:.3f}x), build {t_build:.2f} s; "
        f"{wb.num_nodes} nodes, {wb.num_leaves} leaves, rows "
        f"{packet.row_bytes(wb)} B (default {w0.num_nodes} / "
        f"{w0.num_leaves}, {packet.row_bytes(w0)} B), mode "
        f"{path._hbm_mode(wb)}, stack bound {wb.max_stack} (default "
        f"{w0.max_stack}), K {wb.t_roots.shape[0]}")
    if n_refs <= n_tris or path._hbm_mode(wb) != "hbm":
        raise AssertionError("the presplit build made no references or is "
                             "not HBM-class")
    compare_packet("room_184k/presplit", scene, lens, errs)

    h, w = HD
    o, d, _, _ = _sample_rays(lens, h, w, 0, True, dev)
    n = o.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    tmax = torch.full((n,), INF_T, device=dev)
    shadow = shadow_batch(o, d, packet.closest_hit_packet(w0, o, d, INF_T))
    trees = {"default": w0, "presplit": wb}
    out = {}
    for tree, t in trees.items():
        hp, v_c = packet.closest_hit_plain(t, o, d, tmax, ones,
                                           count_visits=True)
        ap, v_a = packet.any_hit_plain(t, *shadow, count_visits=True)
        out[tree] = dict(hp=hp, ap=ap, v_c=v_c, v_a=v_a,
                         hk=packet.closest_hit_packet(t, o, d, tmax, ones),
                         ak=packet.any_hit_packet(t, *shadow))
        check_closest(f"presplit phase, {tree} tree closest_hit ({n} rays)",
                      out[tree]["hk"], hp, ones, n, tag="presplit")
        check_any(f"presplit phase, {tree} tree any_hit", out[tree]["ak"],
                  ap, t, *shadow)
    k0, k1 = out["default"]["hk"], out["presplit"]["hk"]
    ties_ok = bool(torch.equal(k0.t[k0.tri != k1.tri], k1.t[k0.tri != k1.tri]))
    same = (torch.equal(k0.t, k1.t) and torch.equal(k0.tri >= 0, k1.tri >= 0)
            and ties_ok and torch.equal(out["default"]["ak"],
                                        out["presplit"]["ak"]))
    say("presplit", f"presplit kernel vs default kernel at 1080p: t and "
        f"is_hit equal, tri differs on {int((k0.tri != k1.tri).sum())} "
        f"lanes, all at equal t; occlusion equal: {same}")
    if not same:
        raise AssertionError("the presplit tree's hits differ")
    for kind, key in (("closest", "v_c"), ("any", "v_a")):
        for tree in trees:
            v = out[tree][key]
            say("presplit", f"{kind} hit visits, {tree} tree: {v.nodes} "
                f"node visits ({v.node_slots} slots), {v.leaves} leaf visits "
                f"({v.leaf_tris} triangles)")
    rounds = {f"{kind} {tree}": [] for kind in ("closest", "any")
              for tree in trees}
    for _ in range(3):  # alternated, so clocks hit all alike
        for tree, t in trees.items():
            rounds[f"closest {tree}"].append(cuda_ms(
                lambda t=t: packet.closest_hit_packet(t, o, d, tmax, ones), 5))
            rounds[f"any {tree}"].append(cuda_ms(
                lambda t=t: packet.any_hit_packet(t, *shadow), 5))
    for key, xs in rounds.items():
        kind, tree = key.split()
        name = "closest_hit" if kind == "closest" else "any_hit"
        m = n if kind == "closest" else shadow[0].shape[0]
        b_ms, b_by, _ = bound(name, m, out[tree]["v_c" if kind == "closest"
                                                 else "v_a"], trees[tree])
        say("presplit", f"{name} on {m} lanes, {tree} tree, three alternated "
            f"rounds: " + " / ".join(f"{x:.4f}" for x in xs)
            + f" ms; bound {b_ms:.4f} ms by {b_by}")
    del out, shadow
    spp = 2
    imgs = {}
    for tree, sc in (("default", base), ("presplit", scene)):
        acc, _ = render_spp(sc, lens, 512, 512, 0, spp, cfg)
        imgs[tree] = (acc / spp).cpu().numpy()
    same_image("presplit render vs default build, 512x512 x 2 spp",
               "presplit", imgs["presplit"], imgs["default"])


def glb_builder():
    """tests/glb_builder.py, the repo's glb writer (numpy only)."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import glb_builder

    return glb_builder


def repack_glb(doc: dict, binary: bytes) -> bytes:
    """A .glb of a glTF document and its binary chunk (the buffer's
    length set, both chunks padded to 4 bytes)."""
    import struct

    binary = binary + b"\x00" * (-len(binary) % 4)
    doc["buffers"] = [{"byteLength": len(binary)}]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    total = 12 + 8 + len(js) + 8 + len(binary)
    return (struct.pack("<4sII", b"glTF", 2, total)
            + struct.pack("<I4s", len(js), b"JSON") + js
            + struct.pack("<I4s", len(binary), b"BIN\x00") + binary)


def cornell_jpeg_glb(jpeg: bytes) -> bytes:
    """tests/glb_builder.py's Cornell glb with `jpeg` embedded as image 0
    and made the white walls' base-colour texture (the walls have no
    texcoords, so each triangle reads the default corner uvs)."""
    from moonshine_tpu_torch.scene.gltf import Glb

    g = Glb.parse(glb_builder().cornell_box_glb())
    doc, binary = json.loads(json.dumps(g.json)), bytes(g.binary)
    binary += b"\x00" * (-len(binary) % 4)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(binary),
                               "byteLength": len(jpeg)})
    doc["images"] = [{"bufferView": len(doc["bufferViews"]) - 1,
                      "mimeType": "image/jpeg"}]
    doc["textures"] = [{"source": 0}]
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
        "index": 0}
    return repack_glb(doc, binary + jpeg)


def room_glb(world, lens) -> bytes:
    """A .glb of a procedural World with constant materials, one geometry
    per instance: one glTF mesh per (mesh, material) pair, node matrices
    stored with rows 1 and 2 of the Z-up transform swapped (the loader's
    Y-up -> Z-up row permutation gives each transform back exactly), the
    light's material named "Emitter", and a camera node from the lens."""
    from moonshine_tpu_torch.scene.types import (
        Glass, Lambert, Mirror, StandardPBR,
    )

    sampled = {g.material for inst in world.instances
               for g in inst.geometries if g.sampled}
    materials = []
    for i, info in enumerate(world.materials):
        v, em = info.variant, np.float32(info.emissive)
        m = {"name": "Emitter" if i in sampled else f"material_{i}"}
        if isinstance(v, Glass):
            m["extensions"] = {
                "KHR_materials_transmission": {"transmissionFactor": 1.0},
                "KHR_materials_ior": {"ior": float(v.ior)}}
        elif isinstance(v, Mirror):
            m["pbrMetallicRoughness"] = {"metallicFactor": 1.0,
                                         "roughnessFactor": 0.0}
        else:
            color = [float(c) for c in v.color] + [1.0]
            pbr = isinstance(v, StandardPBR)
            assert pbr or isinstance(v, Lambert)
            m["pbrMetallicRoughness"] = {
                "baseColorFactor": color,
                "metallicFactor": float(v.metalness) if pbr else 0.0,
                "roughnessFactor": float(v.roughness) if pbr else 1.0}
            if pbr:
                m["extensions"] = {"KHR_materials_ior": {"ior": float(v.ior)}}
        if em.any():
            s = float(em.max())
            m["emissiveFactor"] = [float(c) for c in em / s]
            m.setdefault("extensions", {})[
                "KHR_materials_emissive_strength"] = {"emissiveStrength": s}
        materials.append(m)
    meshes, mesh_of, nodes = [], {}, []
    for inst in world.instances:
        (g,) = inst.geometries
        if (g.mesh, g.material) not in mesh_of:
            src = world.meshes[g.mesh]
            assert np.max(src.indices) < 65536
            mesh_of[(g.mesh, g.material)] = len(meshes)
            meshes.append(dict(positions=src.positions, indices=src.indices,
                               normals=src.normals, texcoords=src.texcoords,
                               material=g.material))
        m4 = np.zeros((4, 4), np.float32)
        t = np.asarray(inst.transform, np.float32)
        m4[[0, 2, 1], :] = t
        m4[3, 3] = 1.0
        nodes.append({"mesh": mesh_of[(g.mesh, g.material)],
                      "matrix": m4.T.reshape(-1).tolist()})
    fwd = np.float32(lens.forward)
    up = np.float32(lens.up)
    right = np.cross(fwd, up)
    cam = np.zeros((4, 4), np.float32)
    cam[[0, 2, 1], :3] = np.stack([right / np.linalg.norm(right), up, -fwd],
                                  axis=1)
    cam[[0, 2, 1], 3] = np.float32(lens.origin)
    cam[3, 3] = 1.0
    nodes.append({"camera": 0, "matrix": cam.T.reshape(-1).tolist()})
    cameras = [{"type": "perspective",
                "perspective": {"yfov": float(lens.vfov), "znear": 0.01}}]
    return glb_builder().build_glb(meshes, materials, nodes, cameras)


def offline_phase(dev):
    """The offline CLI: (a) the Cornell golden through the module in a
    subprocess; (b) room_184k through a glb at the CLI's defaults, in
    process with its launches counted, against an in-process render of
    the source World."""
    import torch

    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.io.exr import read_exr, write_exr
    from moonshine_tpu_torch.render import offline
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scene.gltf import lens_from_glb, world_from_glb
    from moonshine_tpu_torch.scripts import skybox

    WORK.mkdir(parents=True, exist_ok=True)
    # (a) the Cornell golden: 96x96, 8 spp, max_bounces 4, mesh NEE only
    (WORK / "cornell.glb").write_bytes(glb_builder().cornell_box_glb())
    write_exr(WORK / "zero_sky.exr", np.zeros((4, 8, 3), np.float32))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "moonshine_tpu_torch.render.offline",
         str(WORK / "cornell.glb"), str(WORK / "zero_sky.exr"),
         str(WORK / "cornell.exr"), "--width", "96", "--height", "96",
         "--spp", "8", "--max-bounces", "4", "--env-samples", "0",
         "--mesh-samples", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    for ln in proc.stdout.strip().splitlines():
        say("offline", f"cornell CLI: {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed:\n{proc.stderr}")
    say("offline", f"cornell CLI process took "
        f"{time.perf_counter() - t0:.1f} s")
    gold = read_exr(ROOT / "tests" / "goldens" / "cornell.exr")[..., :3]
    same_image("cornell CLI vs tests/goldens/cornell.exr", "offline",
               read_exr(WORK / "cornell.exr")[..., :3], gold)

    # (b) room_184k as a glb, at the CLI's defaults
    src, src_lens = procedural.room_scene(grid=6, subdivisions=4,
                                          textured=False)
    t0 = time.perf_counter()
    glb = room_glb(src, src_lens)
    (WORK / "room.glb").write_bytes(glb)
    sky = skybox()
    write_exr(WORK / "sky.exr", sky)
    say("offline", f"room glb {len(glb)} B and {sky.shape[1]}x"
        f"{sky.shape[0]} ZIP skybox "
        f"{(WORK / 'sky.exr').stat().st_size} B written in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    gw = world_from_glb(WORK / "room.glb")
    src.set_background(None)
    gw.set_background(None)
    (want, want_s), (got, got_s) = src.build_arrays(), gw.build_arrays()
    diff = [k for k in want if not np.array_equal(got[k], want[k])]
    diff += [k for k in want_s if got_s[k] != want_s[k]]
    glens = lens_from_glb(WORK / "room.glb")
    lens_err = max(float(np.abs(np.float32(getattr(glens, f))
                                - np.float32(getattr(src_lens, f))).max())
                   for f in ("origin", "forward", "up"))
    lens_err = max(lens_err, abs(glens.vfov - src_lens.vfov))
    say("offline", f"glb world: {len(got['tri_shade'])} triangles, "
        f"build_arrays equal to the source World's in {len(want)} arrays "
        f"and {len(want_s)} statics: {not diff} {diff}; lens max|diff| "
        f"{lens_err:.3g}; both built in {time.perf_counter() - t0:.1f} s")
    if diff or lens_err > 1e-6:
        raise AssertionError("the glb does not give back the source World")
    del want, got

    # the main path: counts set to 0 just before the CLI, read just after
    seen = {}

    def timed_render(*a, **k):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sensor, rays = render(*a, **k)
        torch.cuda.synchronize()
        seen.update(rays=rays, seconds=time.perf_counter() - t1)
        return sensor, rays

    args = [str(WORK / "room.glb"), str(WORK / "sky.exr"),
            str(WORK / "room.exr"), "--spp", str(OFFLINE_SPP)]
    opts = offline.parse_args(args)  # the CLI's defaults but for --spp
    offline.render = timed_render
    torch.cuda.reset_peak_memory_stats()
    packet.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = offline.main(args)
    finally:
        offline.render = render
    wall = time.perf_counter() - t0
    counts = dict(packet.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    for ln in buf.getvalue().strip().splitlines():
        say("offline", f"room CLI: {ln}")
    rays, secs = int(seen["rays"]), seen["seconds"]
    say("offline", f"room CLI {opts.width}x{opts.height} x {opts.spp} spp, "
        f"max_bounces {opts.max_bounces}: exit {rc}, {wall:.1f} s in all; "
        f"render {rays} rays in {secs:.4f} s = {rays / secs / 1e6:.3f} "
        f"Mrays/s, "
        f"{secs / opts.spp * 1e3:.2f} ms/spp, segments per sample "
        f"{counts['closest_hit'] / opts.spp:.2f}, launches {counts}, "
        f"peak device memory {peak:.1f} MiB")
    if rc != 0 or counts["closest_hit"] == 0 or counts["any_hit"] == 0:
        raise AssertionError("the CLI's render launched no kernel")
    got = read_exr(WORK / "room.exr")[..., :3]
    src.set_background(read_exr(WORK / "sky.exr")[..., :3])
    scene = src.build(dev)
    sensor, _ = render(scene, LensArrays.from_lens(glens, dev), opts.height,
                       opts.width, spp=opts.spp, cfg=PathConfig(
                           max_bounces=opts.max_bounces,
                           env_samples_per_bounce=opts.env_samples,
                           mesh_samples_per_bounce=opts.mesh_samples))
    same_image("room CLI vs in-process render of the source World",
               "offline", got, sensor.image.cpu().numpy())
    return scene, LensArrays.from_lens(glens, dev), opts


# --- the progressive-engine slice: jpeg, engine, direct, sharded, viewer ---

# the Cornell golden's settings (tests/goldens/cornell.exr)
CORNELL_OPTS = ["--width", "96", "--height", "96", "--spp", "8",
                "--max-bounces", "4", "--env-samples", "0",
                "--mesh-samples", "1"]


def cli(tag, name, argv):
    """The offline CLI's main on `argv` in this process (the offline
    phase runs it as `python -m` once), its phase lines printed."""
    from moonshine_tpu_torch.render import offline

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = offline.main(argv)
    for ln in buf.getvalue().strip().splitlines():
        say(tag, f"{name} CLI: {ln}")
    say(tag, f"{name} CLI: exit {rc} in {time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"the CLI failed on {name}")

@contextlib.contextmanager
def recording(max_lanes=16384, module=None, names=None):
    """Every kernel launch of `module`'s two wrappers inside the block
    (`names`: kind -> wrapper; by default the packet kernels'), recorded:
    (kind, tree, then the rays, t_max, active mask and the kernel's
    output, each on an evenly spaced subsample of at most `max_lanes`
    lanes). Each lane's result depends on that lane only, so the
    subsample can be held against the plain version; the plain calls
    count no launch. Recording copies at every launch, so the timed runs
    are made outside it and a further run is recorded, on the eager loop
    (graphs.eager()): the wrappers are called at every launch only there,
    and graph replays are held against that loop bit for bit."""
    import torch

    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.integrator import graphs

    if module is None:
        module, names = packet, {"closest_hit": "closest_hit_packet",
                                 "any_hit": "any_hit_packet"}
    rec = []
    real = {kind: getattr(module, name) for kind, name in names.items()}

    def wrap(kind):
        def launch(tree, o, d, t_max, active_in=None):
            out = real[kind](tree, o, d, t_max, active_in)
            n = o.shape[0]
            idx = torch.arange(0, n, max(1, -(-n // max_lanes)),
                               device=o.device)
            sub = lambda x: (x if x is None or not torch.is_tensor(x)
                             or x.ndim == 0 else x[idx].clone())
            rec.append((kind, tree, sub(o), sub(d), sub(t_max),
                        sub(active_in),
                        tuple(sub(x) for x in out) if kind == "closest_hit"
                        else sub(out)))
            return out
        return launch

    for kind, name in names.items():
        setattr(module, name, wrap(kind))
    try:
        with graphs.eager():  # a replay would call no wrapper
            yield rec
    finally:
        for kind, name in names.items():
            setattr(module, name, real[kind])


def hold_recorded(tag, rec, per_kind=4):
    """Up to `per_kind` recorded launches of each kind, evenly spaced over
    the run (the first and the last included), against the plain
    versions bit for bit; returns {kind: launches recorded}."""
    from moonshine_tpu_torch.accel import packet

    plain = {"closest_hit": packet.closest_hit_plain,
             "any_hit": packet.any_hit_plain}
    seen = {}
    for kind in plain:
        runs = [r for r in rec if r[0] == kind]
        seen[kind] = len(runs)
        pick = sorted({round(i * (len(runs) - 1) / max(per_kind - 1, 1))
                       for i in range(per_kind)}) if runs else []
        lanes = 0
        for i in pick:
            _, w, o, d, t, act, out = runs[i]
            want = plain[kind](w, o, d, t, active_in=act)
            assert_same(f"{tag} {kind} launch {i}",
                        out if kind == "any_hit" else packet.Hit(*out),
                        want)
            lanes += o.shape[0]
        say(tag, f"{kind}: {len(runs)} launches recorded, {len(pick)} held "
            f"against the plain version bit for bit on {lanes} lanes")
    return seen


def jpeg_phase(dev):
    """The committed JPEG fixtures against their PIL goldens, the decode
    of a 2048x2048 texture timed on this host, and the Cornell glb with a
    JPEG texture through the CLI against an in-process render."""
    import torch

    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.io.exr import read_exr, write_exr
    from moonshine_tpu_torch.io.jpeg import decode_jpeg
    from moonshine_tpu_torch.render.renderer import render
    from moonshine_tpu_torch.scene.gltf import lens_from_glb, world_from_glb
    from moonshine_tpu_torch.scripts import time_jpeg

    fixtures = ROOT / "tests" / "torch_fixtures"
    for name in sorted(p.stem for p in fixtures.glob("*.jpg")):
        data = (fixtures / f"{name}.jpg").read_bytes()
        gold = np.load(fixtures / f"{name}.npy")
        t0 = time.perf_counter()
        got = decode_jpeg(data, name)
        dt = time.perf_counter() - t0
        same = got.shape == gold.shape and np.array_equal(got, gold)
        say("jpeg", f"{name}.jpg ({len(data)} B, {gold.shape[1]}x"
            f"{gold.shape[0]}): equal to its PIL golden {same}, decode "
            f"{dt * 1e3:.2f} ms (host)")
        if not same:
            raise AssertionError(f"{name}.jpg decodes differently from PIL")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t = time_jpeg.main(["--reps", "1"])
    say("jpeg", f"2048x2048 texture decode on this host (not device time): "
        f"{buf.getvalue().strip()}")
    WORK.mkdir(parents=True, exist_ok=True)
    glb = cornell_jpeg_glb((fixtures / "baseline_420.jpg").read_bytes())
    (WORK / "cornell_jpeg.glb").write_bytes(glb)
    write_exr(WORK / "zero_sky.exr", np.zeros((4, 8, 3), np.float32))
    cli("jpeg", "cornell_jpeg", [
        str(WORK / "cornell_jpeg.glb"), str(WORK / "zero_sky.exr"),
        str(WORK / "cornell_jpeg.exr"), *CORNELL_OPTS])
    world = world_from_glb(glb)
    world.set_background(np.zeros((4, 8, 3), np.float32))
    sensor, _ = render(world.build(dev), lens_from_glb(glb), 96, 96, spp=8,
                       cfg=PathConfig(max_bounces=4, env_samples_per_bounce=0,
                                      mesh_samples_per_bounce=1))
    got = read_exr(WORK / "cornell_jpeg.exr")[..., :3]
    same_image("cornell_jpeg CLI vs in-process render", "jpeg", got,
               sensor.image.cpu().numpy())
    plain = read_exr(ROOT / "tests" / "goldens" / "cornell.exr")[..., :3]
    rel = abs(got.mean() / plain.mean() - 1.0)
    say("jpeg", f"textured walls move the image mean by {rel:.4f} relative "
        f"against the untextured golden")
    if rel < 0.01:
        raise AssertionError("the JPEG texture did not reach the render")
    return t


def engine_phase(room_world, room_lens, dev, launches_out):
    """room_184k through the Engine's handles at 1280x720 with its default
    config: frames, a refit, a material edit, a pick during a frame, a
    checkpoint; the packet kernels against their plain versions on the
    refit rows and on the frames' launches."""
    import threading

    import torch

    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.integrator import path
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.scene.types import translate
    from moonshine_tpu_torch.scene.world import scene_from_arrays
    from moonshine_tpu_torch.scripts.compare_loop import engine_from_world

    h, w = ENGINE_HW
    e = engine_from_world(room_world, dev)
    cfg = e.config
    sensor = e.create_sensor(w, h)
    lens = e.create_lens(room_lens)
    t0 = time.perf_counter()
    scene = e._ensure_scene()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    say("engine", f"room_184k through the Engine's handles: "
        f"{len(room_world.meshes)} meshes, {len(room_world.materials)} "
        f"materials, {len(room_world.instances)} instances, "
        f"{scene.num_tris} triangles; full build {full_s:.3f} s; config "
        f"max_bounces {cfg.max_bounces}, NEE env {cfg.env_samples_per_bounce}"
        f" mesh {cfg.mesh_samples_per_bounce}")
    e.render(sensor, lens)  # warm-up frame
    e.reset_sensor(sensor)
    packet.reset_launch_counts()
    for i in range(4):
        img = e.render(sensor, lens)
        m = e.metrics
        say("engine", f"frame {i}: {m['last_frame_seconds'] * 1e3:.2f} "
            f"ms/frame, {m['last_mrays_per_sec']:.3f} Mrays/s "
            f"({w}x{h}, 1 spp)")
    counts = dict(packet.LAUNCHES)
    say("engine", f"4 frames: launches {counts}, samples "
        f"{e.sample_count(sensor)}, image mean {img[..., :3].mean():.6f}")
    if (counts["closest_hit"] == 0 or e.sample_count(sensor) != 4
            or not np.isfinite(img).all()):
        raise AssertionError("the Engine's frames failed")
    launches_out["engine"] = counts
    with recording() as rec:  # a fifth frame, for the plain versions
        e.render(sensor, lens)
    hold_recorded("engine", rec)

    # a transform edit (the last instance, an object on the floor): a
    # host refit
    moved = len(room_world.instances) - 1
    e.set_instance_transform(moved, translate(0.6, -0.4, 0.3))
    t0 = time.perf_counter()
    refit = e._ensure_scene()
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    if refit.bvh.tri_order is not scene.bvh.tri_order:
        raise AssertionError("the transform edit did not refit")
    t0 = time.perf_counter()
    full = scene_from_arrays(*e.world.build_arrays(), refit.device)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    say("engine", f"set_transform: refit {refit_s * 1e3:.2f} ms against a "
        f"full build of the edited world {rebuild_s:.3f} s (first build "
        f"{full_s:.3f} s)")
    o, d, active, t_fin = test_batch(refit, LensArrays.from_lens(room_lens,
                                                                  dev))
    wb = refit.wide
    hk = packet.closest_hit_packet(wb, o, d, INF_T, active_in=active)
    assert_same("engine refit closest_hit", hk, packet.closest_hit_plain(
        wb, o, d, INF_T, active_in=active))
    assert_same("engine refit any_hit",
                packet.any_hit_packet(wb, o, d, t_fin, active_in=active),
                packet.any_hit_plain(wb, o, d, t_fin, active_in=active))
    hf = packet.closest_hit_packet(full.wide, o, d, INF_T, active_in=active)
    both = (hk.tri >= 0) & (hf.tri >= 0)
    rel = float(((hk.t - hf.t).abs() / hf.t.abs().clamp_min(1e-30))[
        both].max())
    flips = int(((hk.tri >= 0) != (hf.tri >= 0)).sum())
    say("engine", f"refit rows ({o.shape[0]} rays): packet kernels equal "
        f"the plain versions bit for bit; closest-hit t against the full "
        f"build's: max rel {rel:.3g}, is_hit flips {flips}")
    if rel > 1e-5 or flips > 1e-5 * o.shape[0]:
        raise AssertionError("the refit scene disagrees with a full build")

    # a material edit: the material table only
    grey = e.create_solid_texture([0.3, 0.3, 0.3])
    e.set_material_color(0, grey)
    t0 = time.perf_counter()
    mat_scene = e._ensure_scene()
    torch.cuda.synchronize()
    say("engine", f"set_material_color: material-only rebuild "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    if mat_scene.wide is not refit.wide:
        raise AssertionError("the material edit rebuilt the tree")

    # a frame on the edited scene (its first: the scene's graphs are
    # captured), then wait=False on a replayed frame: how long the call
    # blocks against when its frame is done
    e.render(sensor, lens)
    e.reset_sensor(sensor)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e.render(sensor, lens, wait=False)
    call_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    drained = time.perf_counter() - t0
    say("engine", f"render(wait=False) returned after {call_s * 1e3:.2f} ms, "
        f"its frame done on the device at {drained * 1e3:.2f} ms: the "
        f"looped bounce loop reads the live count once a block of "
        f"{path.LOOP_BLOCK} segments, so the call returns once the last "
        f"block is queued")

    # a pick from a second thread during a frame
    started, done = threading.Event(), threading.Event()

    def frame():
        started.set()
        e.render(sensor, lens)
        done.set()

    th = threading.Thread(target=frame)
    th.start()
    if not started.wait(timeout=60):
        raise AssertionError("the frame's thread did not start")
    # into the frame: a quarter of the replayed wait=False frame's time
    time.sleep(min(0.05, drained / 4))
    t0 = time.perf_counter()
    hit = e.pick(lens, w, h, w // 2, 5 * h // 6)  # the floor
    pick_ms = (time.perf_counter() - t0) * 1e3
    during = not done.is_set()
    th.join(timeout=600)
    if th.is_alive():
        raise AssertionError("the frame did not end")
    t0 = time.perf_counter()
    idle = e.pick(lens, w, h, w // 2, 5 * h // 6)
    idle_ms = (time.perf_counter() - t0) * 1e3
    say("engine", f"pick during a frame: {pick_ms:.2f} ms, returned before "
        f"the frame ended {during}, hit instance {hit.instance} geometry "
        f"{hit.geometry} primitive {hit.primitive}; the frame took "
        f"{e.metrics['last_frame_seconds'] * 1e3:.2f} ms; the same pick "
        f"with no frame running {idle_ms:.2f} ms")
    if not hit.hit or not during or idle != hit:
        raise AssertionError("the pick waited for the frame or missed")

    path = WORK / "engine_ckpt.npz"
    e.save_checkpoint(path, sensor)
    s2 = e.create_sensor(w, h)
    e.load_checkpoint(path, s2)
    same = (e.sample_count(s2) == e.sample_count(sensor) and np.array_equal(
        e.get_sensor_data(s2), e.get_sensor_data(sensor)))
    say("engine", f"checkpoint round trip ({path.stat().st_size} B): equal "
        f"{same}, samples {e.sample_count(s2)}")
    if not same:
        raise AssertionError("checkpoint round trip differs")


def direct_phase(scene, lens, launches_out):
    """trace_direct on room_184k's 1080p camera rays (one env and one
    mesh-light sample), timed, its launches held against the plain
    versions."""
    import torch

    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.integrator import shade
    from moonshine_tpu_torch.integrator.direct import DirectConfig, \
        trace_direct
    from moonshine_tpu_torch.render.renderer import _sample_rays

    h, w = HD
    o, d, rng, unpack = _sample_rays(lens, h, w, 0, True, scene.device)
    cfg = DirectConfig()
    trace_direct(scene, o, d, rng, cfg)  # warm-up
    torch.cuda.synchronize()
    packet.reset_launch_counts()
    shade.reset_launch_counts()
    t0 = time.perf_counter()
    rad, _, rays = trace_direct(scene, o, d, rng, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(packet.LAUNCHES)
    shaded = dict(shade.LAUNCHES)
    rays = int(rays)
    img = unpack(rad).cpu().numpy()
    say("direct", f"{w}x{h}: {dt * 1e3:.2f} ms, {rays} rays = "
        f"{rays / dt / 1e6:.3f} Mrays/s, launches {counts}, shading "
        f"launches {shaded}, image mean {img.mean():.6f}")
    if (counts["closest_hit"] != 1 or counts["any_hit"] != 2
            or shaded != dict(surface=1, scatter=0, env_miss=1, env_draw=1,
                              counts=0)
            or not np.isfinite(img).all()):
        raise AssertionError("trace_direct failed")
    launches_out["direct"] = counts
    launches_out["direct_shading"] = shaded
    with recording() as rec:  # the same call again, for the plain versions
        trace_direct(scene, o, d, rng, cfg)
    hold_recorded("direct", rec)


def sharded_phase(scene, lens, dev, launches_out):
    """render_sharded on cuda:0 x4 (sp=2, dp=2) and on mesh_from_spec
    ("auto") against the single-device render; the CLI with --mesh
    auto."""
    import torch

    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.io.exr import read_exr, write_exr
    from moonshine_tpu_torch.parallel import (
        make_mesh, mesh_from_spec, render_sharded,
    )
    from moonshine_tpu_torch.render.renderer import render

    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    h, w, spp = SHARDED_HWS
    render(scene, lens, h, w, 1, cfg)  # warm-up: the graphs' captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sensor, rays_one = render(scene, lens, h, w, spp, cfg)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    ref = sensor.image
    for name, mesh in (("cuda:0 x4 (sp=2, dp=2)",
                        make_mesh([dev] * 4, sp=2)),
                       ("mesh_from_spec('auto')", mesh_from_spec("auto"))):
        render_sharded(scene, lens, h, w, spp, cfg, mesh)  # warm-up
        torch.cuda.synchronize()
        packet.reset_launch_counts()
        t0 = time.perf_counter()
        img, rays = render_sharded(scene, lens, h, w, spp, cfg, mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(packet.LAUNCHES)
        err = float(((img - ref).abs() / ref.abs().clamp_min(1.0)).max())
        say("sharded", f"{name}: {mesh.shape}, {w}x{h} x {spp} spp in "
            f"{dt:.4f} s (single device {one_s:.4f} s), rays {int(rays)} vs "
            f"{rays_one}, max |diff| / max(1, |pixel|) {err:.3g}, launches "
            f"{counts}")
        if (err > 2e-6 or int(rays) != rays_one or counts["closest_hit"] == 0
                or counts["any_hit"] == 0):
            raise AssertionError(f"{name}: the sharded render disagrees")
        launches_out[f"sharded {name}"] = counts
        with recording() as rec:  # again, for the plain versions
            render_sharded(scene, lens, h, w, spp, cfg, mesh)
        hold_recorded("sharded", rec, per_kind=2)
    sharded_1080p(scene, lens, dev, cfg, launches_out)
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "cornell.glb").write_bytes(glb_builder().cornell_box_glb())
    write_exr(WORK / "zero_sky.exr", np.zeros((4, 8, 3), np.float32))
    cli("sharded", "cornell --mesh auto", [
        str(WORK / "cornell.glb"), str(WORK / "zero_sky.exr"),
        str(WORK / "cornell_mesh.exr"), *CORNELL_OPTS, "--mesh", "auto"])
    gold = read_exr(ROOT / "tests" / "goldens" / "cornell.exr")[..., :3]
    same_image("cornell CLI --mesh auto vs tests/goldens/cornell.exr",
               "sharded", read_exr(WORK / "cornell_mesh.exr")[..., :3], gold)


def sharded_1080p(scene, lens, dev, cfg, launches_out, reps=3):
    """room_1080p (1920x1080 x 2 spp) through render_sharded on cuda:0 x4
    (sp=2, dp=2: 540x1920 = 1,036,800 lanes a shard, the staged form)
    and on mesh_from_spec("auto"), each through time_sharded.compare: a
    warm-up call, then `reps` stepped calls alternated with the same
    shards run in turn (launches set to 0 before each call and read
    after it), each with its graph captures (0 after the warm-up),
    replays, live-count reads and scene copies; the image held bit for
    bit against the shards in turn with the same rays and launches, and
    within 2e-6 x max(1, |pixel|) of the one-device render_spp with the
    same rays; then one call profiled (profile_frame.profile: each card's
    busy share and the overlap of the shards on one card), each card's
    memory reserved, and one more
    recorded on the eager loop, its kernel launches held against the
    plain versions bit for bit at the shards' shapes."""
    import torch

    from moonshine_tpu_torch.parallel import (
        make_mesh, mesh_from_spec, render_sharded,
    )
    from moonshine_tpu_torch.render.profile_frame import profile
    from moonshine_tpu_torch.render.renderer import render_spp
    from moonshine_tpu_torch.scripts.time_sharded import (
        CHECKS, compare, timed_run,
    )

    (h, w), spp = HD, 2
    one = lambda: render_spp(scene, lens, h, w, 0, spp, cfg)
    one()  # warm-up: the captures
    (acc, rays_one), one_s, _, _ = timed_run(one)
    ref, rays_one = acc / spp, int(rays_one)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("sharded", f"1080p on {smi}: one device (render_spp) "
        f"{one_s * 1e3:.2f} ms, {rays_one} rays")
    for name, mesh in (("cuda:0 x4 (sp=2, dp=2)",
                        make_mesh([dev] * 4, sp=2)),
                       ("mesh_from_spec('auto')", mesh_from_spec("auto"))):
        (img, rays), launches, rec = compare(scene, lens, h, w, spp, cfg,
                                             mesh, ref, rays_one, reps)
        call = lambda: render_sharded(scene, lens, h, w, spp, cfg, mesh)
        prof = profile(call)
        reserved = {str(d): round(torch.cuda.memory_reserved(d) / 2**30, 3)
                    for d in sorted(set(mesh.devices.flat), key=str)}
        ms = lambda xs: [round(x * 1e3, 2) for x in xs]
        counts = rec["per_call"]
        say("sharded", f"1080p {name}: {mesh.shape}, {w}x{h} x {spp} spp, "
            f"ms per call {ms(rec['stepped_s'])} (warm-up "
            f"{rec['first_call_s']['stepped'] * 1e3:.2f}; the shards in "
            f"turn {ms(rec['in_turn_s'])}; one device {one_s * 1e3:.2f}); "
            f"per call {counts['replays']} replays, {counts['reads']} reads, "
            f"{counts['captures']} captures, {counts['copies']} scene "
            f"copies (warm-up {rec['first_call']['stepped']}; in turn "
            f"{rec['in_turn_per_call']}); checks "
            f"{ {k: rec[k] for k in CHECKS} }; rays {int(rays)} vs "
            f"{rays_one} on one device, max |diff| / max(1, |pixel|) "
            f"{rec['max_rel_err']:.3g}; launches {launches}; profiled: "
            f"{prof['wall_ms_profiled']:.2f} ms, {prof['replays']} replays,"
            f" {prof['host_reads']} reads, by card {prof['devices']}; "
            f"memory reserved by card (GiB) {reserved}; {smi}")
        if (not all(rec[k] for k in CHECKS) or launches["closest_hit"] == 0
                or launches["any_hit"] == 0
                or not torch.isfinite(img).all()):
            raise AssertionError(f"1080p {name}: the sharded render "
                                 "disagrees or captured again")
        launches_out[f"sharded_1080p {name}"] = launches
        with recording() as recorded:  # again, for the plain versions
            call()
        hold_recorded("sharded_1080p", recorded, per_kind=2)


def viewer_phase(world, lens, dev):
    """run_web on a free local port: a frame over HTTP equals tonemap of
    the sensor; a material edit and a key reset the sample count."""
    import threading
    import urllib.request

    from moonshine_tpu_torch.io.png import decode_png
    from moonshine_tpu_torch.render.viewer import Viewer, tonemap
    from moonshine_tpu_torch.scripts.compare_loop import engine_from_world

    v = Viewer(engine_from_world(world, dev), lens, 256, 256)
    th = threading.Thread(target=lambda: v.run_web(
        port=0, background_render=False), daemon=True)
    th.start()
    try:
        deadline = time.time() + 30
        while v.port is None and time.time() < deadline:
            time.sleep(0.05)
        base = f"http://127.0.0.1:{v.port}"

        def post(path, body):
            req = urllib.request.Request(base + path, method="POST",
                                         data=json.dumps(body).encode())
            return urllib.request.urlopen(req, timeout=60).read()

        for _ in range(2):
            v.step()
        t0 = time.perf_counter()
        png = urllib.request.urlopen(base + "/frame.png", timeout=60).read()
        get_ms = (time.perf_counter() - t0) * 1e3
        rgba = decode_png(png)
        want = tonemap(v.engine.get_sensor_data(v.sensor))
        same = np.array_equal(rgba[..., :3], want)
        status = json.loads(urllib.request.urlopen(base + "/status",
                                                   timeout=60).read())
        say("viewer", f"port {v.port}: GET /frame.png {len(png)} B in "
            f"{get_ms:.2f} ms, equal to tonemap of the sensor {same}; status "
            f"samples {status['samples']}, last frame "
            f"{status['last_frame_seconds'] * 1e3:.2f} ms")
        info = json.loads(post("/pick", {"u": 0.5, "v": 0.5}))
        post("/edit/material", {"color": [0.9, 0.2, 0.1], "roughness": 0.5})
        after_edit = v.engine.sample_count(v.sensor)
        v.step()
        post("/key/w", {})
        after_key = v.engine.sample_count(v.sensor)
        say("viewer", f"pick {info}; samples after the material edit "
            f"{after_edit}, after a step and the key 'w' {after_key}")
        if (not same or status["samples"] != 2 or not info.get("hit")
                or after_edit != 0 or after_key != 0):
            raise AssertionError("the viewer's round trip failed")
    finally:
        v.stop()
        th.join(timeout=30)
    if th.is_alive():
        raise AssertionError("the viewer's server did not stop")


TLAS_HOLD_LANES = 65_536  # lanes of each recorded launch held bit for bit


def tlas_bound(name, n, visits, t):
    """(bound_ms, bound_by, detail) of one two-level launch on n rays:
    each ray's inputs and outputs and the structure moved once, against
    the box, triangle and entry operations over fp32 peak. `visits` is
    the plain version's count on the same rays (TlasVisits: the
    reference's walk over the reference's arrays, one box a node visit)
    or the kernel's own (WalkVisits: its walk over its records, the boxes
    it tested)."""
    from moonshine_tpu_torch.accel import tlas

    closest = "closest" in name
    if isinstance(visits, tlas.WalkVisits):
        arrays = [t.walk.nodes, t.walk.tris, t.inst_inv, t.top_inst,
                  t.walk.inst_root]
        boxes = visits.boxes
        what = (f"{visits.top} top and {visits.blas} BLAS 8-wide node "
                f"visits ({visits.top / max(n, 1):.2f} + "
                f"{visits.blas / max(n, 1):.2f} a ray), {boxes} boxes "
                f"({boxes / max(n, 1):.1f} a ray)")
    else:
        arrays = [getattr(t, k) for k in tlas.ARRAY_FIELDS]
        boxes = visits.top + visits.blas
        what = (f"{visits.top} top and {visits.blas} BLAS node visits "
                f"({visits.top / max(n, 1):.1f} + "
                f"{visits.blas / max(n, 1):.1f} a ray)")
    struct_b = sum(x.numel() * x.element_size() for x in arrays)
    nbytes = n * (12 + 12 + 4 + 1 + (20 if closest else 1)) + struct_b
    flops = (boxes * tlas.FLOPS_PER_BOX + visits.tris * tlas.FLOPS_PER_TRI
             + visits.entries * tlas.FLOPS_PER_ENTRY)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, (
        f"{what}, {visits.entries} instance entries, {visits.leaves} leaf "
        f"visits, {visits.tris} triangle tests; {nbytes / 1e6:.2f} MB -> "
        f"{t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP -> {t_ops:.4f} ms")


def tlas_phase(dev, cfg, timings, errs, launches):
    """instanced_1080p: 4096 instances of icosphere(6) (81,920 triangles;
    335,544,320 flattened, past the 16M cap), built two-level by the cap
    with its warning; 1920x1080 x 2 spp with the tlas counts set to 0
    just before and read just after; a recorded 1-spp run whose first and
    a later launch of each kind are held against the plain versions bit
    for bit on 65,536 lanes (the plain closest hit timed there); the
    kernels at the frame's largest launches against their plain versions
    bit for bit, timed, bounded by the plain versions' visit counts and by
    the kernel's own (its counting build); procedural.tie_scene (exact
    equal-t ties) on 65,536 rays bit for bit; then a 40-instance world
    rendered flattened and two-level within the reference's bounds."""
    import warnings

    import torch

    from moonshine_tpu_torch.accel import tlas
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import render_spp
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scripts import compare_tlas

    t0 = time.perf_counter()
    world, lens = procedural.instanced_scene()
    t_make = time.perf_counter() - t0
    flat = sum(len(world.meshes[g.mesh].indices) for inst in world.instances
               for g in inst.geometries)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scene = world.build(dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    warned = [str(w.message) for w in caught
              if "two-level instancing" in str(w.message)]
    t = scene.tlas
    say("tlas", f"instanced_1080p: {len(world.instances)} instances, "
        f"{flat:,} triangles flattened, {t.num_obj_tris} object triangles "
        f"({scene.num_tris} shading rows), {t.top_left.shape[0]} top and "
        f"{t.blas_left.shape[0]} BLAS nodes; scene made in {t_make:.2f} s, "
        f"built in {t_build:.2f} s; warning: {warned[0] if warned else None}")
    if t is None or scene.wide is not None or not warned or \
            os.environ.get("MSN_FORCE_TLAS") == "1":
        raise AssertionError("instanced_1080p did not go two-level by the cap")
    la = LensArrays.from_lens(lens, dev)

    img, stats, counts = render_1080p("instanced_1080p", scene, la, cfg,
                                      resort=False)
    # the shading kernels, the counts they fold in and a sample's camera
    # rays and accumulation; no other kernel runs on a two-level scene
    shading = ("surface", "scatter", "env_miss", "env_draw", "counts",
               "raygen", "accumulate")
    if (counts["tlas_closest_hit"] != stats["segments"]
            or counts["tlas_any_hit"] == 0
            or counts["surface"] != stats["segments"]
            or counts["scatter"] != counts["tlas_any_hit"]
            or any(counts[k] for k in counts
                   if not k.startswith("tlas") and k not in shading)):
        raise AssertionError(f"instanced_1080p launches {counts}, segments "
                             f"{stats['segments']}")
    launches.update(tlas_closest_hit=counts["tlas_closest_hit"],
                    tlas_any_hit=counts["tlas_any_hit"])
    if not 0.05 < float(img.mean()) < 10.0:
        raise AssertionError("instanced_1080p image mean out of range")

    with recording(TLAS_HOLD_LANES, tlas, {"closest_hit": "closest_hit_tlas",
                                           "any_hit": "any_hit_tlas"}) as rec:
        render_spp(scene, la, HD[0], HD[1], 7, 1, cfg)
    plain = {"closest_hit": tlas.closest_hit_tlas_plain,
             "any_hit": tlas.any_hit_tlas_plain}
    for kind, fn in plain.items():
        runs = [r for r in rec if r[0] == kind]
        for i in (0, min(2, len(runs) - 1)):
            _, tt, o, d, tm, act, out = runs[i]
            if i == 0 and kind == "closest_hit":
                want = None

                def run():
                    nonlocal want
                    want = fn(tt, o, d, tm, active_in=act)
                ms = host_ms(run)
                say("tlas", f"plain closest hit on {o.shape[0]} lanes of "
                    f"the camera launch: {ms:.2f} ms in torch ops")
            else:
                want = fn(tt, o, d, tm, active_in=act)
            got = out if kind == "any_hit" else tlas.TlasHit(*out)
            assert_same(f"tlas {kind} launch {i}", got, want)
            live = int(act.sum()) if act is not None else o.shape[0]
            say("tlas", f"{kind} launch {i} of {len(runs)}: {o.shape[0]} "
                f"lanes ({live} live) bit for bit against the plain version")

    batches = compare_tlas.batches(scene, la, dev)
    for name, (ro, rd, tm, act, any_hit) in batches.items():
        fk = tlas.any_hit_tlas if any_hit else tlas.closest_hit_tlas
        fp = tlas.any_hit_tlas_plain if any_hit else \
            tlas.closest_hit_tlas_plain
        got = fk(t, ro, rd, tm, act)
        res = {}

        def run_plain():
            res["out"] = fp(t, ro, rd, tm, act, count_visits=True)
        plain_ms = host_ms(run_plain)
        want, visits = res["out"]
        assert_same(f"{name} at {ro.shape[0]} rays", got, want)
        errs[name] = 0.0
        ms = cuda_ms(lambda: fk(t, ro, rd, tm, act), 5)
        b_ms, by, detail = tlas_bound(name, ro.shape[0], visits, t)
        own = tlas.walk_visits(t, ro, rd, tm, act, any_hit)
        w_ms, w_by, w_detail = tlas_bound(name, ro.shape[0], own, t)
        timings[name] = {"ms": round(ms, 4), "plain_ms": round(plain_ms, 2),
                         "bound_ms": round(b_ms, 4), "bound_by": by}
        say("tlas", f"{name} on {ro.shape[0]} rays ({int(act.sum())} live): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms (visits counted), "
            f"bit for bit; bound on the reference's visits {b_ms:.4f} ms "
            f"({by}: {detail}); {ms / b_ms:.1f}x it")
        say("tlas", f"{name}: bound on the kernel's own walk (its counting "
            f"build) {w_ms:.4f} ms ({w_by}: {w_detail}); {ms / w_ms:.1f}x "
            f"it; the {'own walk' if w_ms >= b_ms else 'reference'}'s "
            f"governs (the larger)" + (
                "; the kernel runs below the reference-visit bound: its "
                "walk does fewer visits" if ms < b_ms else ""))

    # exact equal-t ties: instances under one transform, repeated triangles
    world, o_np, d_np = procedural.tie_scene(TLAS_HOLD_LANES, seed=1)
    tt = tlas.device_tlas(tlas.build_tlas(world.meshes, world.instances)[0],
                          dev)
    o, d = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
    for fk, fp, tm in ((tlas.closest_hit_tlas, tlas.closest_hit_tlas_plain,
                        INF_T),
                       (tlas.any_hit_tlas, tlas.any_hit_tlas_plain, 14.0)):
        got = fk(tt, o, d, tm)
        assert_same(f"tie scene {fk.__name__}", got, fp(tt, o, d, tm))
    hit = tlas.closest_hit_tlas(tt, o, d, INF_T)
    # an instance with a twin (same transform, same BLAS) ties every hit
    twin = ((tt.inst_inv[:, None] == tt.inst_inv[None]).all(-1)
            & (tt.inst_root[:, None] == tt.inst_root[None])).sum(1) > 1
    ties = int(twin[hit.inst[hit.is_hit].long()].sum())
    say("tlas", f"tie scene: {o.shape[0]} rays, {int(hit.is_hit.sum())} "
        f"hits, {ties} of them on an instance with a twin (a tie in t); "
        f"both kernels bit for bit against the plain versions")
    if ties == 0:
        raise AssertionError("the tie scene holds no tie")

    world, small_lens = procedural.instanced_scene(grid=(8, 5),
                                                   subdivisions=4)
    sl = LensArrays.from_lens(small_lens, dev)
    with env(MSN_MAX_FLAT_TRIS="1000000000"):
        flat_scene = world.build(dev)
    with env(MSN_FORCE_TLAS="1"):
        world, _ = procedural.instanced_scene(grid=(8, 5), subdivisions=4)
        two_scene = world.build(dev)
    if flat_scene.tlas is not None or two_scene.tlas is None:
        raise AssertionError("the 40-instance builds took the wrong route")
    ref, _ = render_spp(flat_scene, sl, 512, 512, 0, 2, cfg)
    got, _ = render_spp(two_scene, sl, 512, 512, 0, 2, cfg)
    ref, got = (ref / 2).cpu().numpy(), (got / 2).cpu().numpy()
    close = float(np.isclose(got, ref, rtol=5e-3, atol=5e-3).mean())
    rel = abs(got.mean() / ref.mean() - 1.0)
    say("tlas", f"40 instances of icosphere(4) ({flat_scene.num_tris} "
        f"triangles flattened), 512x512 x 2 spp: two-level against "
        f"flattened {close:.4%} of values within 5e-3, means "
        f"{got.mean():.6f} / {ref.mean():.6f} (rel {rel:.3g})")
    if close < 0.995 or rel > 2e-3 or not np.isfinite(got).all():
        raise AssertionError("two-level and flattened renders disagree")
    return scene, la


# Float operations a lane, counted from csrc/shade.cu's source (a
# transcendental as one), each charged only on the lanes whose outputs
# need it: the bounds' operation terms. Tuples are by material type
# (glass, lambert, mirror, pbr: bsdf/materials.py's ids).
SHADE_OPS = {
    "surface": 236,  # full form, a live lane: decode, frames, pick, w_o_ss
    "surface_thin": 53,  # thin form, a live lane: position, uv, tri_n
    "two_level": 153,  # full form: the corners' and normals' transform
    "two_level_thin": 66,  # thin form: the corners' transform
    "normal_map": 87,  # _texture_frame and its pick (not normals_flat)
    "atlas_bsdf": 70, "atlas_emissive": 38,  # a 4-tap fetch
    "emission": 15, "emission_mis": 28,  # a live lane; mesh-light MIS
    "roulette": 10,  # luminance, clamp, test, the throughput's scale
    "draw_env": (61, 47),  # an env sample with its shadow ray, by env
    # size > 1 and == 1
    "draw_mesh": 122,  # a mesh sample: alias pick, point, normal, pdf,
    # the two-ended segment
    "draw_mesh_atlas": 48,  # its uv and emissive fetch (textured)
    "scatter_light": (74, 48, 45, 180),  # a NEE sample's weighted lane
    "scatter_draw": (53, 22, 2, 58),  # a live lane: PCG draw, sample_bsdf
    "scatter_ray": (83, 55, 54, 173),  # a lane that goes on: the new
    # ray, eval_bsdf, the throughput
    # the env miss's: scripts/compare_shade.py MISS_OPS
    "env_draw": (41, 27),  # every lane, by env size > 1 and == 1
}
# The kernels' earlier forms (every lane computed and written, the
# bounce's light draw in torch) at the same shapes, as PERF.md section 6
# records them, printed beside this run's times
EARLIER_MS = {("room_1080p", "surface/full"): 0.1948,
           ("room_1080p", "surface/thin"): 0.0187,
           ("room_1080p", "scatter"): 0.2426,
           ("instanced_1080p", "surface/full"): 0.2258,
           ("instanced_1080p", "surface/thin"): 0.0683,
           ("instanced_1080p", "scatter"): 0.1993}


def _distinct(x):
    """The number of distinct values of an index tensor."""
    import torch

    return int(torch.unique(x).numel())


def _atlas_taps(plane, rect, uv):
    """The atlas rows a 4-tap fetch (scene/textures.py
    sample_material_block) reads at these lanes, as one index tensor."""
    import torch

    x0, y0 = rect[:, 0].to(torch.int64), rect[:, 1].to(torch.int64)
    tw, th = rect[:, 2], rect[:, 3]
    iu = torch.floor(uv[:, 0] * tw - 0.5).to(torch.int32)
    iv = torch.floor(uv[:, 1] * th - 0.5).to(torch.int32)
    base = ((y0 + torch.remainder(iv, th.to(torch.int32))) * plane.width
            + x0 + torch.remainder(iu, tw.to(torch.int32)))
    taps = torch.cat([base + k for k in (0, 1, plane.width,
                                         plane.width + 1)])
    return torch.clamp(taps, 0, plane.data.shape[0] - 1)


def _alias_bytes(select, alias, count, rand, row_bytes):
    """The bytes an alias draw reads at uniforms `rand`: each distinct
    bucket's select (4), alias (8) where it is not kept, and each
    distinct picked row."""
    import torch

    from moonshine_tpu_torch.core import alias_table

    idx = torch.clamp_max((rand * float(count)).to(torch.int64), count - 1)
    picked, _ = alias_table.sample(select, alias, count, rand)
    return (_distinct(idx) * 4 + _distinct(idx[picked != idx]) * 8
            + _distinct(picked) * row_bytes), picked


def _surface_work(args, out):
    """shade_work of the surface kernel in its path forms (full with the
    bounce's light draw, thin)."""
    import torch

    from moonshine_tpu_torch.core import rng as R
    from moonshine_tpu_torch.integrator import shade

    count = lambda mask: int(mask.sum())
    scene, mesh, _, hit, o, d, active, thr, rad, lp, ld, mode = args[:12]
    draw = args[12] if len(args) > 12 else None
    atlas = scene.mat_atlas
    n = hit.tri.shape[0]
    tri = torch.clamp(hit.tri.to(torch.int64), 0, scene.num_tris - 1)
    two = hit.inst is not None and scene.tlas is not None
    n_live = count(active)
    n_samples = draw.env_samples + mesh if draw is not None else 0
    # every lane: its mask and shadow lanes; a live lane: its hit, ray
    # direction, radiance in and out, the emission's state (throughput,
    # last_delta; last_pdf and o for the mesh-light MIS)
    nb = n * (1 + n_samples) + n_live * (
        12 + (4 if two else 0) + 12 + 24 + 12 + 1 + (16 if mesh > 0 else 0))
    if mode == "thin":
        nb += n_live  # its mask cleared
    else:
        nb += n_live * 112  # the decoded hit
    uvs = mode != "thin" or not atlas.emissive_constant
    row = 36 + (24 if uvs else 0) + (
        12 if atlas.emissive_constant else 16) + 4
    if mode != "thin":
        row += 36 + (36 if atlas.bsdf_constant else 24)
    rows = tri[active]
    nb += _distinct(rows) * row
    flops = n_live * (SHADE_OPS["surface_thin" if mode == "thin"
                                else "surface"] + SHADE_OPS["emission"]
                      + (SHADE_OPS["emission_mis"] if mesh > 0 else 0))
    if mode != "thin" and not atlas.normals_flat:
        flops += n_live * SHADE_OPS["normal_map"]
    if two:
        inst = torch.clamp(hit.inst[active].to(torch.int64), 0,
                           scene.inst_tf.shape[0] - 1)
        nb += _distinct(inst) * (52 + (0 if mode == "thin" else 36))
        flops += n_live * SHADE_OPS["two_level_thin" if mode == "thin"
                                    else "two_level"]
    if not (atlas.emissive_constant and atlas.bsdf_constant):
        tr = scene.tri_shade[rows]
        uv = shade._interp(hit.u[active], hit.v[active],
                           tr[:, 18:24].reshape(-1, 3, 2))
        if not atlas.bsdf_constant and mode != "thin":
            nb += _distinct(_atlas_taps(atlas.bsdf, tr[:, 33:37], uv)) * 14
            flops += n_live * SHADE_OPS["atlas_bsdf"]
        if not atlas.emissive_constant:
            nb += _distinct(_atlas_taps(atlas.emissive, tr[:, 44:48],
                                        uv)) * 6
            flops += n_live * SHADE_OPS["atlas_emissive"]
    if draw is None:
        return nb, flops
    # the termination: a live lane's PCG state in and, where it stays
    # live, out; a scaled throughput out; a killed lane's mask out
    alive = out.active
    n_alive = count(alive)
    nb += n_live * 8 + n_alive * 8 + (n_live - n_alive)
    if draw.roulette:
        nb += n_alive * 12
        flops += n_live * SHADE_OPS["roulette"]
    # the draws of the lanes live after it and not on a delta material,
    # from the same PCG streams
    drawn = alive & ~((out.mat.type == 0) | (out.mat.type == 2))
    state, _ = R.next_float(draw.rng)
    env = draw.env
    em = scene.emitters
    for k in range(n_samples):
        state, r2 = R.next_float2(state)
        r2 = r2[drawn]
        traced = out.lights.lane[k]
        nb += count(traced) * 56  # the sample and its shadow ray out
        if k < draw.env_samples:
            if env.size > 1:
                nb += _alias_bytes(env.select, env.alias,
                                   env.size * env.size, r2[:, 0], 16)[0]
            else:
                nb += 16
            flops += count(drawn) * SHADE_OPS["draw_env"][
                0 if env.size > 1 else 1]
            continue
        taken, slot = _alias_bytes(em.select, em.alias, max(em.count, 1),
                                   r2[:, 0], 100)
        nb += taken
        flops += count(drawn) * SHADE_OPS["draw_mesh"]
        if not atlas.emissive_constant:
            rows_em = em.rows[torch.clamp(slot, 0, em.rows.shape[0] - 1)]
            flops += count(drawn) * SHADE_OPS["draw_mesh_atlas"]
            s = torch.sqrt(torch.clamp_min(1.0 - r2[:, 0], 0.0))
            bary = torch.stack([1.0 - s, r2[:, 1] * s], -1)
            uv = shade._interp(bary[:, 0], bary[:, 1],
                               rows_em[:, 9:15].reshape(-1, 3, 2))
            nb += _distinct(_atlas_taps(atlas.emissive, rows_em[:, 18:22],
                                        uv)) * 6
    return nb, flops


def shade_work(key, args, out):
    """(bytes, float operations) the shading function must move and do
    for these inputs, given its outputs `out`: each output written once,
    on the lanes it is written on; each lane input read once, on the lanes
    whose outputs depend on it (a dead lane's state, a hit lane's env
    inputs, an untraced or occluded light sample are not read); each
    distinct shading row (the fields the form reads), instance transform,
    atlas texel, env texel, emitter row and alias bucket the lanes reach,
    once; SHADE_OPS' operations on the lanes that need them."""
    import torch

    count = lambda mask: int(mask.sum())
    name = key.split("/")[0].split()[0]
    if name == "surface":
        return _surface_work(args, out)
    if name == "scatter":
        surf, o, d, thr, rad, rng, active, lights = args[:8]
        n = active.shape[0]
        mtype = surf.mat.type.to(torch.int64)
        ops_of = lambda lanes, ops: int(
            (torch.bincount(mtype[lanes], minlength=4)[:4]
             * torch.tensor(ops, device=mtype.device)).sum())
        go = out["active"]
        live = active
        # every lane: its mask in and out; a live lane: the material,
        # w_o_ss, throughput, radiance and rng in and out, last_pdf and
        # last_delta out
        nb = n * 2 + count(live) * (28 + 12 + 12 + 24 + 16 + 5)
        flops = ops_of(live, SHADE_OPS["scatter_draw"])
        weighted = torch.zeros_like(go)
        for k in range(0 if lights is None else lights.pdf.shape[0]):
            lane = lights.lane[k] & live
            seen = lane & ~lights.occluded[k]
            need = seen & (lights.pdf[k] > 0.0)
            nb += count(live) + count(lane) + 4 * count(seen) + 24 * count(
                need)
            flops += ops_of(need, SHADE_OPS["scatter_light"])
            weighted |= need
        # the frame where a sample is weighted or the path goes on; there
        # the new ray's inputs (position, tri_n) and outputs (o, d,
        # throughput)
        nb += count(go | weighted) * 36 + count(go) * (24 + 36)
        flops += ops_of(go, SHADE_OPS["scatter_ray"])
        return nb, flops
    if name == "env_miss":
        from moonshine_tpu_torch.scripts.compare_shade import miss_work

        return miss_work(args)
    env, rand2 = args
    n = rand2.shape[0]
    nb = n * (8 + 28)
    if env.size == 1:
        return nb + 16, n * SHADE_OPS["env_draw"][1]
    nb += _alias_bytes(env.select, env.alias, env.size * env.size,
                       rand2[:, 0], 16)[0]
    return nb, n * SHADE_OPS["env_draw"][0]


def shade_phase(cells, timings, errs):
    """The shading kernels (csrc/shade.cu) at the 1080p main path's
    shapes: one eager sample of each cell (room_1080p, instanced_1080p)
    recorded (scripts/compare_shade.py `recording`), and the first launch
    of each kernel and form (2,073,600 lanes: the first segment's; the
    thin form at the last segment's) replayed through the kernel and
    through its plain version on the same inputs, every output held bit
    for bit on the lanes the kernel writes it (`held`), both timed (the
    kernel's in-place inputs restored before each launch), with the bound
    from the bytes and operations of these inputs and the earlier form's
    recorded time beside. The env miss also runs at live shares of 10%
    and 1% of its launch's lanes (a seeded subset of its mask), where
    only a lane that missed works. The env draw, on the direct
    integrator's path since the surface draws a bounce's samples, runs on
    2,073,600 seeded uniforms. The kernels line takes room_1080p's full
    surface form and its other kernels, the env miss at its full share."""
    import torch

    from moonshine_tpu_torch.integrator import shade
    from moonshine_tpu_torch.scripts import compare_shade as CS

    plain = {"surface": shade.surface_plain, "scatter": shade.scatter_plain,
             "env_miss": shade.env_miss_plain,
             "env_draw": shade.env_draw_plain}
    for cell, (scene, lens, cfg) in cells.items():
        rec = CS.record_sample(scene, lens, cfg)
        if set(rec) != {"surface/full", "surface/thin", "scatter",
                        "env_miss"}:
            raise AssertionError(f"{cell}: recorded {sorted(rec)}")
        n = rec["env_miss"][1][3].shape[0]
        rand2 = torch.from_numpy(np.random.RandomState(5).rand(n, 2).astype(
            np.float32)).to(scene.device)
        rec["env_draw"] = ("env_draw", (scene.env, rand2), {})
        # the env miss also at live shares of 10% and 1% of its recorded
        # launch's lanes (seeded), as the deep segments launch it
        name, args, kw = rec["env_miss"]
        for share in CS.SHARES[1:]:
            rec[f"env_miss {share:.0%} live"] = (name, CS.thinned(args, share),
                                                 kw)
        for key in sorted(rec):
            name, args, kw = rec[key]
            kernel = getattr(shade, name)
            got = kernel(*CS.fresh(name, args), **CS.clone(kw))
            want = plain[name](*args, **kw)
            diffs, worst = CS.compare(key, args, got, want)
            work = CS.fresh(name, args)
            ms = CS.time_inplace(CS.call(kernel, work, CS.clone(kw)), work,
                                 args, 20)
            plain_ms = cuda_ms(CS.call(plain[name], args, kw), 3)
            nb, flops = shade_work(key, args, want)
            t_bytes, t_ops = nb / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            before = EARLIER_MS.get((cell, key))
            lanes = (f"{n} lanes ({int(args[4].sum())} live)"
                     if name == "env_miss" else f"{n} lanes")
            say("shade", f"{cell} {key} on {lanes}: kernel "
                + ("= plain bit for bit (" + ", ".join(CS.outputs(want))
                   + ")" if not diffs else "differs: " + "; ".join(diffs))
                + f"; kernel {ms:.4f} ms"
                + (f" (earlier form {before:.4f} ms, PERF.md)" if before
                   else "")
                + f", plain torch {plain_ms:.3f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms by {by} ({nb / 1e6:.2f} MB ->"
                f" {t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP -> "
                f"{t_ops:.4f} ms); no single PyTorch call computes it, so no "
                f"library time")
            if diffs:
                raise AssertionError(f"{cell} {key}: the kernel differs from "
                                     "its plain version")
            if cell == "room_1080p" and key in ("surface/full", "scatter",
                                                "env_miss", "env_draw"):
                timings[name] = dict(ms=ms, plain_ms=plain_ms,
                                     bound_ms=max(t_bytes, t_ops),
                                     bound_by=by)
                errs[name] = worst


def sort_phase(scenes, offline_cell, cfg, timings, errs):
    """The lane sort (csrc/sort.cu) at the main path's shapes: one eager
    1080p sample of room_1080p (the resort and the packet dispatch's
    sorts: 2,073,600 camera rays, the 4,147,200-lane shadow batch) and
    of treelet_1080p (the treelet dispatch's sort) recorded
    (scripts/compare_sort.py `site_calls`), and each site's first call
    replayed through the kernels and through the plain version on the
    same inputs: the coherence key from the lanes it was made of, the
    permutation against torch.argsort(key, stable=True) and every moved
    column bit for bit; each timed beside the argsort alone (the one
    PyTorch call that computes the permutation), the plain version, the
    parent's form (argsort, a gather of every lane array, and for the
    resort the copy back into the loop's buffers) and the bound; the
    permutation passes and the move timed apart, beside their own bounds
    (the move's also counted in 32-byte sectors); the whole resort (key,
    sort, moves) against the parent's. The inverse (unsort_lanes) the
    same way. Then room_1080p and one offline_720p sample rendered with
    the plain versions patched into core/sortutil.py (graphs captured
    anew) against the kernels' render: image and rays bit for bit, every
    other kernel's launches equal; one more sample of each way timed."""
    import torch

    from moonshine_tpu_torch.accel import native
    from moonshine_tpu_torch.core import sortutil
    from moonshine_tpu_torch.integrator import graphs, path
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.renderer import render_sample, render_spp
    from moonshine_tpu_torch.scripts import compare_sort as cs

    h, w = HD
    room, room_lens = scenes["room_184k/default"]
    tree, tree_lens = scenes["room_184k/treelet"]
    calls = cs.site_calls(room, room_lens, tree, tree_lens, cfg)
    lib = native.sort_lib()
    lane_names = [k for k in path._init_state(
        torch.zeros(1, 3), torch.zeros(1, 3), torch.zeros(1)) if k != "rays"]

    for site in cs.SITES:
        bits, (key_in, arrays, rows, out_shapes) = calls[site]
        if not isinstance(key_in, sortutil.KeyIn):
            raise AssertionError(f"{site} sorted a key, not its inputs")
        key = sortutil.coherence_key_plain(*key_in)  # on the card
        n = key.shape[0]
        # the key the sort's first kernel makes, and its permutation
        k_run, k_perm, made = cs.keyed_of(lib, key_in, bits)
        k_run()
        ok = (cs.bits_equal(made, key) and cs.bits_equal(
            k_perm, torch.argsort(key, stable=True).int()))
        key_plain_ms = cuda_ms(lambda: sortutil.coherence_key_plain(
            *key_in), 20)
        keyed_ms = cuda_ms(k_run, 20)
        key_bytes = cs.key_in_bytes(key_in)
        b = cs.bounds(n, [], [], lib.passes(bits), key_bytes)
        say("sort", f"{site}: the coherence key made in the sort's first "
            f"kernel = plain bit for bit, and its permutation = "
            f"torch.argsort of the plain key: {ok}; key + passes "
            f"{keyed_ms:.4f} ms, the plain key alone {key_plain_ms:.4f} ms;"
            f" bound {b['key_perm'][0]:.4f} ms by {b['key_perm'][1]} "
            f"({b['key_perm'][2]})")
        if not ok:
            raise AssertionError(f"{site}: the coherence key differs")
        rows = rows or [a.shape[0] for a in arrays]
        fresh = lambda: (None if out_shapes is None else [
            torch.zeros(sh, dtype=a.dtype, device=a.device)
            for sh, a in zip(out_shapes, arrays)])
        out_k, out_p = fresh(), fresh()
        perm, got = sortutil.sort_lanes(key_in, arrays, bits, out=out_k,
                                        rows=rows)
        want_perm, want = sortutil.sort_lanes_plain(key_in, arrays, bits,
                                                    out=out_p, rows=rows)
        lib_perm = torch.argsort(key, stable=True)
        ok = (cs.bits_equal(perm, lib_perm.int())
              and cs.bits_equal(perm, want_perm)
              and all(cs.bits_equal(g, w_) for g, w_ in zip(got, want)))
        live = int((key != sortutil.DEAD_KEY).sum())
        say("sort", f"{site}: {n} lanes ({live} live keys, bits {bits}, "
            f"{len(arrays)} arrays, rows {rows}): permutation = "
            f"torch.argsort(key, stable=True) and every moved column = "
            f"the plain version bit for bit: {ok}")
        if not ok:
            raise AssertionError(f"{site}: the sort kernels differ")
        out_t = fresh()
        ms = cuda_ms(lambda: sortutil.sort_lanes(key_in, arrays, bits,
                                                 out=out_t, rows=rows), 20)
        lib_ms = cuda_ms(lambda: torch.argsort(key, stable=True), 20)
        plain_ms = cuda_ms(lambda: sortutil.sort_lanes_plain(
            key_in, arrays, bits, out=out_t, rows=rows), 5)
        statics = [torch.empty_like(a) for a in arrays]

        def parent():  # argsort, a gather an array (the resort's copied
            p = torch.argsort(key, stable=True)  # back into its buffers)
            for a, st in zip(arrays, statics):
                if site == "resort":
                    st.copy_(a[p])
                else:
                    a[p]

        parent_ms = cuda_ms(parent, 5)
        b = cs.bounds(n, arrays, rows, lib.passes(bits), key_bytes)
        b_ms, b_by, detail = b["sort"]
        say("sort", f"{site}: kernels (the key made in the first) {ms:.4f} "
            f"ms, torch.argsort alone {lib_ms:.4f} ms, plain version (the "
            f"key, argsort + gathers) "
            f"{plain_ms:.4f} ms, the parent's form (argsort, gathers"
            + (", copy back" if site == "resort" else "")
            + f") {parent_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
            f"({detail})")
        # the two parts apart: the permutation passes and the move
        p_run, p_perm = cs.passes_of(lib, key, bits)
        m_run, m_out = cs.move_of(lib, lib_perm.int(), arrays, rows,
                                  out_shapes, False)
        p_run()
        m_run()
        ok = cs.bits_equal(p_perm, lib_perm.int()) and all(
            cs.bits_equal(g, w_) for g, w_ in zip(m_out, want))
        passes_ms, move_ms = cuda_ms(p_run, 20), cuda_ms(m_run, 20)
        say("sort", f"{site}: the permutation passes alone {passes_ms:.4f} "
            f"ms (bound {b['perm'][0]:.4f} ms by {b['perm'][1]}: "
            f"{b['perm'][2]}), the move alone {move_ms:.4f} ms (bound "
            f"{b['move'][0]:.4f} ms by bytes: {b['move'][2]}; by 32-byte "
            f"sectors {b['move_sectors'][0]:.4f} ms: "
            f"{b['move_sectors'][2]}), each = torch.argsort and the plain "
            f"moves bit for bit: {ok}")
        if not ok:
            raise AssertionError(f"{site}: the passes or the move differ")
        if site == "resort":
            timings["sort_lanes"] = dict(ms=ms, plain_ms=plain_ms,
                                         bound_ms=b_ms, bound_by=b_by,
                                         library_ms=lib_ms)
            errs["sort_lanes"] = 0.0
            # the whole resort, the key included, into the other buffers
            st = dict(zip(lane_names, arrays))
            st["rays"] = torch.zeros((), dtype=torch.int64,
                                     device=key.device)
            dst = {k: (v if k == "rays" else torch.empty_like(v))
                   for k, v in st.items()}
            width = min(rows)
            whole = cuda_ms(lambda: path._resort_state(
                room, st, out=dst, prefix=n, width=width), 20)

            def parent_whole():
                k_ = sortutil.coherence_key_plain(
                    st["o"], st["d"], room.wide.bounds, path.RESORT_CELLS,
                    st["active"])
                p = torch.argsort(k_, stable=True)
                for name in lane_names:
                    dst[name].copy_(st[name][p])

            parent_whole_ms = cuda_ms(parent_whole, 5)
            say("sort", f"the whole resort at {n} lanes (width {width}): "
                f"key + sort + moves {whole:.4f} ms against the torch form, "
                f"key + argsort + gathers + copy back {parent_whole_ms:.4f}"
                f" ms; bound (the key's inputs {key_bytes / 1e6:.1f} MB) "
                f"{b_ms:.4f} ms")

    _, (perm, arrays) = calls["unsort"]
    got = sortutil.unsort_lanes(perm, arrays)
    want = sortutil.unsort_lanes_plain(perm, arrays)
    ok = all(cs.bits_equal(g, w_) for g, w_ in zip(got, want))
    say("sort", f"unsort_lanes on {h * w} lanes ({len(arrays)} arrays): "
        f"kernel = plain (index_copy_) bit for bit: {ok}")
    if not ok:
        raise AssertionError("unsort_lanes differs from its plain version")
    ms = cuda_ms(lambda: sortutil.unsort_lanes(perm, arrays), 20)
    plain_ms = cuda_ms(lambda: sortutil.unsort_lanes_plain(perm, arrays), 20)
    b = cs.bounds(h * w, arrays, [h * w] * len(arrays), 0)
    b_ms, b_by, detail = b["sort"]
    say("sort", f"unsort_lanes: kernel {ms:.4f} ms, plain (an index_copy_ "
        f"an array) {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"({detail}; by 32-byte sectors {b['move_sectors'][0]:.4f} ms); no "
        f"single PyTorch call moves several arrays by one permutation, so "
        f"no library time")
    timings["unsort_lanes"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)
    errs["unsort_lanes"] = 0.0

    # the plain versions patched in: the same renders
    o_scene, o_lens, opts = offline_cell
    o_cfg = PathConfig(max_bounces=opts.max_bounces,
                       env_samples_per_bounce=opts.env_samples,
                       mesh_samples_per_bounce=opts.mesh_samples)
    cells = {"room_1080p": lambda i: render_spp(room, room_lens, h, w, i, 1,
                                                cfg),
             "offline_720p": lambda i: render_sample(
                 o_scene, o_lens, opts.height, opts.width, i, o_cfg)}
    names = ("sort_lanes", "unsort_lanes")
    real = {k: getattr(sortutil, k) for k in names}
    for name, sample in cells.items():
        runs = {}
        for form in ("kernels", "plain"):
            if form == "plain":
                for k in names:
                    setattr(sortutil, k, getattr(sortutil, f"{k}_plain"))
            try:
                graphs.clear()
                sample(1)  # the warm-up: its captures
                reset_counts()
                img, rays = sample(0)
                torch.cuda.synchronize()
                counts = read_counts()
                ms = host_ms(lambda: sample(2))
                runs[form] = (img, int(rays), counts, ms)
            finally:
                for k in names:
                    setattr(sortutil, k, real[k])
                graphs.clear()
        (ik, rk, ck, mk), (ip, rp, cp, mp) = runs["kernels"], runs["plain"]
        same = (bool(torch.equal(ik, ip)) and rk == rp
                and {k: v for k, v in ck.items() if k not in names}
                == {k: v for k, v in cp.items() if k not in names})
        say("sort", f"{name} with the plain key, sort and moves patched in: "
            f"image, rays ({rk}) and launches equal the kernels' run: "
            f"{same}; sort launches (sort, inverse) "
            + " + ".join(str(ck[k]) for k in names) + " (kernels) against "
            + " + ".join(str(cp[k]) for k in names) + f" (plain); a sample "
            f"as graph replays {mk:.2f} ms (kernels) against {mp:.2f} ms "
            f"(plain)")
        if not same or ck["sort_lanes"] == 0 or any(cp[k] for k in names):
            raise AssertionError(f"{name}: the plain sort's render differs")


def shadow_compact_phase(room, lens, cfg):
    """room_1080p (1920x1080 x 1 spp, the staged path, as graph replays)
    with MSN_SHADOW_COMPACT=1, which sorts each resorted segment's shadow
    batch inside the any-hit dispatch (packet._sorted), against the
    default: image and rays bit for bit, the traversal and shading
    launches equal, more sorts."""
    import torch

    from moonshine_tpu_torch.integrator import graphs
    from moonshine_tpu_torch.render.renderer import render_spp

    if not room.has_delta:
        raise AssertionError("room_184k holds no mirror or glass: "
                             "MSN_SHADOW_COMPACT would change nothing")
    runs = {}
    for flag in ("0", "1"):
        with env(MSN_SHADOW_COMPACT=flag):
            render_spp(room, lens, HD[0], HD[1], 1, 1, cfg)  # captures
            reset_counts()
            graphs.reset_counts()
            t0 = time.perf_counter()
            img, rays = render_spp(room, lens, HD[0], HD[1], 0, 1, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            runs[flag] = (img, int(rays), read_counts(),
                          graphs.COUNTS["replays"])
        say("shadow_compact", f"MSN_SHADOW_COMPACT={flag}: {ms:.2f} ms/spp,"
            f" {runs[flag][1]} rays, {runs[flag][3]} graph replays, "
            f"launches {runs[flag][2]}")
    (i0, r0, c0, _), (i1, r1, c1, replays) = runs["0"], runs["1"]
    sorts = ("sort_lanes", "unsort_lanes")
    same_image = bool(torch.equal(i0, i1)) and r0 == r1
    same = same_image and ({k: v for k, v in c0.items() if k not in sorts}
                           == {k: v for k, v in c1.items() if k not in sorts})
    say("shadow_compact", f"image and rays equal the default's: "
        f"{same_image}; and the traversal / shading launches: {same}; "
        f"sorts {c0['sort_lanes']} -> {c1['sort_lanes']}, unsorts "
        f"{c0['unsort_lanes']} -> {c1['unsort_lanes']}")
    if not same or replays == 0 or c1["unsort_lanes"] <= c0["unsort_lanes"]:
        raise AssertionError("MSN_SHADOW_COMPACT=1 differs from the default "
                             "or sorted no shadow batch as graph replays")


def say_stages(tag, name, prof):
    """One line: a profiled sample's kernel ms by stage range
    (integrator/path.py STAGES), their sum and what lies outside them."""
    from moonshine_tpu_torch.integrator import path

    staged = {k: prof[k]["kernel_ms"] for k in path.STAGES}
    total = sum(staged.values())
    say(tag, f"{name} stage split (eager, kernel ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in staged.items())
        + f"; stages {total:.3f} of {prof['kernel_ms']:.3f} ms of kernels "
        f"({total / max(prof['kernel_ms'], 1e-9):.2%}), outside "
        f"{prof['kernel_ms'] - total:.3f} ms; resort calls "
        f"{prof['resort']['calls']}")
    return staged


def graph_if_phase(dev, timings, errs):
    """The conditional nodes' kernels (csrc/graph_cond.cu, behind
    graphs.cond / choose / loop) against their plain versions. The set
    kernel: one graph of a one-branch SWITCH node for each (sel, value)
    pair, int64 and bool, whose body writes 1 into the pair's flag, and
    one of a six-branch switch on a (prev, w) pair (the resorted
    segment's width choice) replayed at every pair of -1..3, replayed;
    the flags must equal `sel == value` in torch. The loop's tail: a
    graphs.loop of 16 steps (as the looped form's block: each step sets
    the live count from a schedule, the tail counts it and sets the next
    guard), replayed on schedules whose live count reaches 0 mid-block,
    whose cap stops it, and that run every step, against the eager loop
    (graphs.eager()): writes, counter, live count and launch counts.
    Then times, each from CUDA events over 50 replays after one: a
    skipped IF node (a graph of 64 whose predicates are false, per node:
    the set kernel's `ms`); a six-branch switch that matches none against
    six skipped IF nodes; the eager form of a branch, the predicate read
    on the host (`plain_ms`, per read, host clock); the looped form's
    segment guard and count per segment: the earlier form (a set kernel
    with two terms, the IF node, the count's add in its body) against the
    folded one (the IF node and the tail kernel: the tail's `ms`), both
    taken with that body alone and skipped, against the eager form (the
    add and a host read of the guard: the tail's `plain_ms`); and a read
    of the live count as the loop makes it (a pinned copy, an event, its
    wait) after a one-kernel replay, against the replay alone. Bounds:
    the 8 bytes of sel read over the HBM rate (the set kernel); the
    counter read and written and the live count read, 24 bytes (the
    tail)."""
    import torch

    from moonshine_tpu_torch.integrator import graphs

    big = 1 << 40
    pairs = [(v, k) for v in (-big, -1, 0, 1, 2, 7, big)
             for k in (0, 1, 2, big)]
    sels = [torch.tensor(v, dtype=torch.int64, device=dev) for v, _ in pairs]
    sels += [torch.tensor(b, device=dev) for b in (True, False, True)]
    values = [k for _, k in pairs] + [1, 1, 0]
    flags = torch.zeros(len(values), dtype=torch.int64, device=dev)

    def step():
        for i, (sel, value) in enumerate(zip(sels, values)):
            graphs.choose(sel, {value: lambda i=i: flags[i:i + 1].fill_(1)})

    steps = graphs.Steps(dev)
    steps.run("pairs", step)  # the eager run, then the capture
    flags.zero_()
    steps.run("pairs", step)
    plain = torch.stack([(s == v).to(torch.int64)
                         for s, v in zip(sels, values)])
    torch.cuda.synchronize()
    err = float((flags - plain).abs().max())
    # the six-branch switch at every (prev, w) pair, none matching too
    prev, w = (torch.zeros((), dtype=torch.int64, device=dev)
               for _ in range(2))
    keys = [(p, k) for p in range(3) for k in range(p + 1)]
    ran = torch.zeros(len(keys), dtype=torch.int64, device=dev)
    six = {key: (lambda i=i: ran[i:i + 1].add_(1))
           for i, key in enumerate(keys)}
    steps.run("six", lambda: graphs.choose((prev, w), six))
    switch_err = 0.0
    for p in range(-1, 4):
        for k in range(-1, 4):
            prev.fill_(p)
            w.fill_(k)
            ran.zero_()
            steps.run("six", lambda: graphs.choose((prev, w), six))
            want = torch.tensor([int(key == (p, k)) for key in keys],
                                device=dev)
            switch_err = max(switch_err, float((ran - want).abs().max()))
    errs["graph_if"] = max(err, switch_err)
    say("graphs", f"graph_if: {len(values)} one-branch switches (int64 "
        f"and bool selectors) against sel == value: max abs err {err}; a "
        f"six-branch switch at each of 25 (prev, w) pairs (19 with no "
        f"branch): max abs err {switch_err}")
    if err != 0 or switch_err != 0 or int(flags.sum()) != int(plain.sum()):
        raise AssertionError("a conditional node took the wrong branch")

    errs["graph_tail"] = folded_guard_check(dev)

    def events_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    false = torch.zeros((), dtype=torch.bool, device=dev)
    x = torch.zeros(1, device=dev)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    bounce = torch.zeros_like(live)
    nomatch = torch.full((), 9, dtype=torch.int64, device=dev)
    n_if = 64
    go = ((live, ">", 0), (bounce, "<", 1 << 40))

    def skipped():
        for _ in range(n_if):
            graphs.cond(false, lambda: x.add_(1.0))

    def switches():
        for _ in range(n_if):
            graphs.choose(nomatch, {i: lambda: x.add_(1.0)
                                    for i in range(6)})

    def guards():  # the earlier form: a set kernel and an IF node a step
        for _ in range(n_if):
            graphs.cond(go, lambda: bounce.add_(1))

    def folded():  # the loop's: the IF node and the tail a step
        graphs.loop(go, [lambda: None] * n_if, bounce,
                    lambda: bounce.add_(1))

    def inline():
        for _ in range(n_if):
            x.add_(1.0)

    def eager_steps():  # the eager form: the guard read, the add
        graphs.loop(go, [lambda: None] * n_if, bounce,
                    lambda: bounce.add_(1))

    one = graphs.Steps(dev)
    live.fill_(1)
    for key, fn in (("skipped", skipped), ("switches", switches),
                    ("guards", guards), ("folded", folded),
                    ("inline", inline), ("kernel", lambda: x.add_(1.0))):
        one.run(key, fn)
    if_ms = events_ms(lambda: one.run("skipped", skipped)) / n_if
    switch_ms = events_ms(lambda: one.run("switches", switches)) / n_if
    live.fill_(0)
    guard_ms = events_ms(lambda: one.run("guards", guards)) / n_if
    folded_skip_ms = events_ms(lambda: one.run("folded", folded)) / n_if
    live.fill_(1)
    taken_ms = events_ms(lambda: one.run("guards", guards)) / n_if
    folded_ms = events_ms(lambda: one.run("folded", folded)) / n_if
    inline_ms = events_ms(lambda: one.run("inline", inline)) / n_if
    read_ms = host_ms(lambda: [false.item() for _ in range(50)]) / 50
    with graphs.eager():
        eager_ms = host_ms(eager_steps) / n_if
    host = torch.empty((), dtype=torch.int64, pin_memory=True)
    landed = torch.cuda.Event()

    def replay_read():
        one.run("kernel", lambda: x.add_(1.0))
        host.copy_(live, non_blocking=True)
        landed.record()
        landed.synchronize()
        int(host)

    t_replay = min(host_ms(lambda: [one.run("kernel", lambda: x.add_(1.0))
                                    for _ in range(50)]) for _ in range(3))
    t_read = min(host_ms(lambda: [replay_read() for _ in range(50)])
                 for _ in range(3))
    bound = 8 / PEAK_BYTES * 1e3
    timings["graph_if"] = dict(ms=if_ms, plain_ms=read_ms, bound_ms=bound,
                               bound_by="bytes", switch6_ms=switch_ms)
    timings["graph_tail"] = dict(ms=folded_ms, plain_ms=eager_ms,
                                 bound_ms=24 / PEAK_BYTES * 1e3,
                                 bound_by="bytes", guard_ms=taken_ms,
                                 skipped_ms=folded_skip_ms)
    say("graphs", f"graph_if: a skipped IF node {if_ms * 1e3:.2f} us (a "
        f"replay of {n_if}), a six-branch switch that matches none "
        f"{switch_ms * 1e3:.2f} us (six IF nodes: "
        f"{6 * if_ms * 1e3:.2f} us), the eager branch's host read of its "
        f"predicate {read_ms * 1e3:.2f} us; a looped segment's guard and "
        f"count, the earlier form (set kernel, IF node, add) taken "
        f"{taken_ms * 1e3:.2f} us and skipped {guard_ms * 1e3:.2f} us, "
        f"folded (IF node, tail kernel) taken {folded_ms * 1e3:.2f} us "
        f"and skipped {folded_skip_ms * 1e3:.2f} us, eager (host read, "
        f"add) {eager_ms * 1e3:.2f} us, one kernel inline "
        f"{inline_ms * 1e3:.2f} us; a one-kernel replay "
        f"{t_replay / 50 * 1e3:.2f} us on the host clock, with a read of "
        f"the live count after it {t_read / 50 * 1e3:.2f} us (the read "
        f"{(t_read - t_replay) / 50 * 1e3:.2f} us); bounds {bound:.3g} ms "
        f"(8 bytes), tail {24 / PEAK_BYTES * 1e3:.3g} ms (24 bytes)")


def folded_guard_check(dev) -> float:
    """graphs.loop of 16 steps, as the looped form's block, captured and
    replayed against the eager loop on schedules of the live count: it
    reaches 0 after the fifth step (a later step would make lanes live
    again), the cap stops it after the twelfth, every step runs; two
    replays of each, alternated. Returns the max abs difference of the
    steps' writes (0), raising where the counter, the live count or the
    launch counts differ, or a replay launched more than the loop's one
    set kernel and a tail a step that ran."""
    import torch

    from moonshine_tpu_torch.accel import launch
    from moonshine_tpu_torch.integrator import graphs

    n, cap = 16, 12
    live = torch.zeros((), dtype=torch.int64, device=dev)
    bounce = torch.zeros_like(live)
    sched = torch.zeros(n, dtype=torch.int64, device=dev)
    x = torch.zeros(n, device=dev)
    counts = launch.Counts({"step": 0})
    schedules = {"stop at 5": [5, 4, 3, 2, 0] + [9] * (n - 5),
                 "cap": [1] * n, "all": [2] * n}

    def step(i):
        launch.count_launch(counts, "step")
        live.copy_(sched[i])
        x[i:i + 1].add_(float(i + 1))

    def block(c):
        graphs.loop(((live, ">", 0), (bounce, "<", c)),
                    [lambda i=i: step(i) for i in range(n)], bounce,
                    lambda: bounce.add_(1), guard_first=True)

    def run(name, fn):
        sched.copy_(torch.tensor(schedules[name], device=dev))
        live.fill_(7)
        bounce.zero_()
        x.zero_()
        counts["step"] = 0
        graphs.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return (x.clone(), int(bounce), int(live), counts["step"],
                graphs.LAUNCHES["graph_if"], graphs.LAUNCHES["graph_tail"])

    caps = {"stop at 5": cap, "cap": cap, "all": 1 << 40}
    with graphs.eager():
        want = {name: run(name, lambda c=c: block(c))
                for name, c in caps.items()}
    steps = graphs.Steps(dev)
    for name, c in caps.items():  # the eager run, the warm, the capture
        run(name, lambda c=c, name=name: steps.run(name, lambda: block(c)))
    err = 0.0
    for name in ["stop at 5", "cap", "all", "stop at 5", "cap", "all"]:
        got = run(name, lambda c=caps[name], name=name: steps.run(
            name, lambda: block(c)))
        err = max(err, float((got[0] - want[name][0]).abs().max()))
        if got[1:4] != want[name][1:4] or got[4] != 1 or got[5] != got[3]:
            raise AssertionError(f"folded guard on {name}: {got[1:]} "
                                 f"against the eager {want[name][1:]}")
    ran = {k: v[1] for k, v in want.items()}
    say("graphs", f"graph_tail: a loop of {n} steps replayed against the "
        f"eager loop (steps run {ran}): writes, counter, live count and "
        f"launches equal, one set kernel and a tail a step run a replay; "
        f"max abs err {err}")
    if ran != {"stop at 5": 5, "cap": cap, "all": n} or err != 0:
        raise AssertionError("the folded guards ran the wrong steps")
    return err


def graphs_phase(cells, stage_profiles) -> dict:
    """Each cell's sample (`cells`: name -> sample(i), which renders
    sample i and returns (image, rays or None)) on the eager loop
    (graphs.eager()) and as graph replays, each from a clear cache: a
    warm-up sample (for the graphs, their captures), then sample 0 with
    the launch counts and graphs.COUNTS set to 0 just before and read
    just after, held bit for bit against the other mode's (image, rays,
    launches), with the device memory's peaks (allocated and reserved,
    from the warm-up on), the sample's conds (device-side choices read
    eagerly; IF nodes in the graphs), reads of the live count and
    replays, and its segments (renderer._sample_sum's); as graph replays
    the unrolled cells read the host 0 times, the looped ones (max
    bounces 1024) at most ceil(segments / LOOP_BLOCK) + 1 times. Then
    sample 2 timed and profiled (render/profile_frame.py `profile`):
    ms/spp, kernels, graph replays, host dispatches and reads, kernel
    time and the device's idle share; last, what stays reserved once the
    allocator's cache of freed blocks is emptied (the graphs' pools and
    static buffers stay). On the eager loop one more sample is profiled
    with the stage ranges (integrator/path.py STAGES): each stage's
    kernel time, their sum against the sample's (kept in
    `stage_profiles` by cell). As graph replays the set kernels
    (graphs.LAUNCHES "graph_if") a sample are at most 6 on room_1080p
    (one SWITCH node a resorted segment) and at most one a block on the
    looped cells (each block's first guard; the first block has none)
    plus one for the resorted state's buffer set, and the looped cells
    run one loop tail ("graph_tail") a segment, the unrolled ones none.
    Returns {"graph_if": room_1080p's set kernels a sample, "graph_tail":
    offline_720p's tails}."""
    import torch

    from moonshine_tpu_torch.integrator import graphs, path
    from moonshine_tpu_torch.render import renderer
    from moonshine_tpu_torch.render.profile_frame import profile

    segs = []
    sample_sum = renderer._sample_sum

    def recorded(*args, **kwargs):  # the segments, a device count
        out = sample_sum(*args, **kwargs)
        segs.append(out[2])
        return out

    renderer._sample_sum = recorded
    cond_launches = {}
    try:
        for name, sample in cells.items():
            rows = {}
            for mode in ("eager", "graphs"):
                with (graphs.eager() if mode == "eager"
                      else contextlib.nullcontext()):
                    graphs.clear()
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    sample(1)
                    reset_counts()
                    graphs.reset_launch_counts()
                    graphs.reset_counts()
                    segs.clear()
                    img, rays = sample(0)
                    torch.cuda.synchronize()
                    counts = {k: v for k, v in read_counts().items() if v}
                    ifs = graphs.LAUNCHES["graph_if"]
                    tails = graphs.LAUNCHES["graph_tail"]
                    loop = dict(graphs.COUNTS)
                    segments = sum(int(s) for s in segs)
                    peak = (torch.cuda.max_memory_allocated() / 2**20,
                            torch.cuda.max_memory_reserved() / 2**20)
                    prof = profile(lambda: sample(2))
                    prof.pop("by_name_us")
                    if mode == "eager":
                        stage_profiles[name] = profile(
                            lambda: sample(2), marks=path.STAGES)
                        say_stages("graphs", name, stage_profiles[name])
                    torch.cuda.empty_cache()  # the cache of freed blocks
                    held = torch.cuda.memory_reserved() / 2**20
                rows[mode] = (img, rays, counts, peak, prof)
                say("graphs", f"{name} {mode}: sample 0: {segments} "
                    f"segments, {loop['conds']} conds, {loop['reads']} "
                    f"reads, {loop['replays']} replays, {loop['captures']} "
                    f"captures, {ifs} set kernels and {tails} loop tails "
                    f"run; sample 2: "
                    f"{prof['wall_ms_unprofiled']:.2f}"
                    f" ms/spp ({prof['wall_ms_profiled']:.2f} profiled), "
                    f"{prof['kernels']} kernels in {prof['replays']} graph "
                    f"replays and {prof['host_dispatches']} host "
                    f"dispatches, {prof['host_reads']} host reads, kernel "
                    f"time {prof['kernel_ms']:.2f} ms, busy "
                    f"{prof['busy_ms']:.2f} ms, device idle "
                    f"{prof['idle_share']:.1%}; peak device memory "
                    f"{peak[0]:.1f} MiB allocated, {peak[1]:.1f} MiB "
                    f"reserved, {held:.1f} MiB reserved after empty_cache; "
                    f"launches a sample {counts}")
                if mode == "graphs":
                    limit = (0 if name in ("room_184k", "room_1080p",
                                           "instanced_1080p")
                             else -(-segments // path.LOOP_BLOCK) + 1)
                    if loop["reads"] > limit or loop["conds"] or \
                            loop["captures"]:
                        raise AssertionError(
                            f"{name}: {loop} a replayed sample of "
                            f"{segments} segments (at most {limit} reads)")
                    looped = name in ("offline_720p", "engine_720p")
                    blocks = -(-segments // path.LOOP_BLOCK)
                    if ((name == "room_1080p" and not 0 < ifs <= 6)
                            or (looped and (ifs > blocks or tails
                                            != segments))
                            or (not looped and tails)):
                        raise AssertionError(
                            f"{name}: {ifs} set kernels and {tails} tails "
                            f"in a replayed sample of {segments} segments")
                    cond_launches[name] = {"graph_if": ifs,
                                           "graph_tail": tails}
            (ei, er, ec, _, ep), (gi, gr, gc, _, gp) = rows["eager"], \
                rows["graphs"]
            same_rays = (er is None and gr is None) or int(er) == int(gr)
            same = bool(torch.equal(torch.as_tensor(ei),
                                    torch.as_tensor(gi))
                        and same_rays and ec == gc)
            say("graphs", f"{name}: replays equal the eager loop bit for "
                f"bit (image, rays, launches): {same}; ms/spp "
                f"{ep['wall_ms_unprofiled']:.2f} -> "
                f"{gp['wall_ms_unprofiled']:.2f}, host dispatches a "
                f"sample {ep['host_dispatches']} -> "
                f"{gp['host_dispatches']}, host reads "
                f"{ep['host_reads']} -> {gp['host_reads']}")
            if not same or not np.isfinite(np.asarray(torch.as_tensor(
                    gi).cpu())).all():
                raise AssertionError(f"{name}: graph replays differ from "
                                     "the eager loop")
            if gp["replays"] == 0 or ep["replays"] != 0:
                raise AssertionError(f"{name}: the graphs did not replay, "
                                     "or the eager loop did")
    finally:
        renderer._sample_sum = sample_sum
    graphs.clear()
    say("graphs", f"conditional-node kernels a replayed sample: "
        f"{cond_launches}")
    return {"graph_if": cond_launches["room_1080p"]["graph_if"],
            "graph_tail": cond_launches["offline_720p"]["graph_tail"]}


# the shapes the frame phase holds the camera rays and the accumulation
# at: (height, width, y0, bh, nbatch, the resort's pix)
FRAME_SHAPES = {"room_1080p": (1080, 1920, 0, 1080, 1, True),
                "offline_720p": (720, 1280, 0, 720, 1, False),
                "band_540": (1080, 1920, 540, 540, 1, True),
                "1024x576x3": (576, 1024, 0, 576, 3, True)}
RAYGEN_LANE_BYTES = 70  # o 12, d 12, rng 8, active 1, throughput 12,
# radiance 12, last_pdf 4, last_delta 1, pix 8: written once a lane
RAYGEN_LANE_FLOPS = 100  # float ops a lane (a transcendental counts one)


def accumulate_check(label, acc, rad, pix, nb):
    """The accumulation kernel on acc [bh, W, 4] against its plain version
    bit for bit, with a tally (the frame's rays, segments and sample
    index, added in the same launch); each timed beside the bound (bytes:
    radiance and pix read, three floats of acc read and written) and, at
    one sample a batch, one `index_add_` over each lane's composed pixel
    index into a [bh, W, 3] accumulator (the index made outside the
    timing). Returns the kernels line's row."""
    import torch

    from moonshine_tpu_torch.render import frame_kernels as FK
    from moonshine_tpu_torch.scripts import compare_frame as CF

    bh, w = acc.shape[0], acc.shape[1]
    n, dev = rad.shape[0], acc.device
    scalar = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    tallies = [FK.Tally(rays=scalar(11), trace_rays=scalar(7 * n),
                        segments=scalar(3), bounce=scalar(4),
                        sample=scalar(2**32 + 5)) for _ in range(2)]
    got, want = acc.clone(), acc.clone()
    FK.accumulate(got, rad, pix, nb, tallies[0])
    FK.accumulate_plain(want, rad, pix, nb, tallies[1])
    same = CF.bits_equal(got, want) and all(
        int(a) == int(b) for a, b in zip(*tallies))
    library, lib_note = None, ""
    if nb == 1:  # one add a pixel: index_add_'s atomics give the same bits
        acc3 = acc[..., :3].contiguous()
        library = CF.library_call(acc3, rad, CF.pixel_index(bh, w, pix,
                                                            dev))
        library()
        lib_note = (f" (its sum = plain bit for bit "
                    f"{CF.bits_equal(acc3, want[..., :3])})")
    ms = cuda_ms(lambda: FK.accumulate(got, rad, pix, nb), 20)
    plain_ms = cuda_ms(lambda: FK.accumulate_plain(want, rad, pix, nb), 5)
    library_ms = None if library is None else cuda_ms(library, 20)
    nbytes = CF.accumulate_bytes(n, bh, w, pix is not None)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (n + 0.0) / PEAK_FP32 * 3e3  # an add a value
    say("frame", f"accumulate {label} ({n} lanes, {nb} a batch): kernel = "
        f"plain bit for bit (acc and the tally's adds) {same}; kernel "
        f"{ms:.4f} ms, plain torch {plain_ms:.4f} ms, bound {t_bytes:.4f} "
        f"ms by bytes ({nbytes / 1e6:.1f} MB; {t_ops:.5f} ms of adds), "
        + (f"index_add_ {library_ms:.4f} ms{lib_note}" if nb == 1 else
           "no one PyTorch call sums several samples a pixel in order"))
    if not same:
        raise AssertionError(f"accumulate {label}: the kernel differs from "
                             "its plain version")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes", library_ms=library_ms)


def frame_phase(scenes, offline_cell, stage_profiles, cfg, timings, errs):
    """The kernels of csrc/frame.cu (render/frame_kernels.py) at the main
    path's shapes (FRAME_SHAPES: room_1080p's 2,073,600 lanes,
    offline_720p's 921,600, a 540-row band of the 1080p frame, 1024x576
    x 3 samples a batch, tiled): the raygen kernel into a trace's buffers
    (filled with junk first) against its plain version (the camera rays
    of each sample and _Trace.reset), every buffer and scalar bit for bit;
    the accumulation (`accumulate_check`) against its plain version on
    seeded radiance and a seeded permutation for pix, and on room_1080p's
    own radiance and pix (scripts/compare_frame.py `record_accumulate`:
    the pix of its last resort), bit for bit with the tally's adds; each
    timed beside its plain version, its bound and, at one sample a batch,
    `index_add_`. Then the counts folded into the shading kernels:
    room_1080p's first full surface launch and first scatter and
    offline_720p's at segment OFFLINE_SEGMENT recorded
    (scripts/compare_shade.py) and replayed with their counters, each
    count against the plain version's and the torch sum of the kernel's
    own mask, and against 0 with every lane dead, exactly; each kernel
    timed with and without its counter (cold L2), beside the torch
    reductions they replace and torch.count_nonzero on room_1080p's
    masks. Last, the eager stage split (`stage_profiles`, the graphs
    phase's) of room_1080p and offline_720p: the camera range holds one
    raygen launch a sample besides scalar fills, the accumulate range one
    accumulation, the live_count range no reduction, the env range the
    miss kernel alone."""
    import torch

    from moonshine_tpu_torch.integrator import path
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render import frame_kernels as FK
    from moonshine_tpu_torch.render.renderer import render_sample
    from moonshine_tpu_torch.scripts import compare_frame as CF
    from moonshine_tpu_torch.scripts import compare_shade as CS

    room, lens = scenes["room_184k/default"]
    dev = room.device
    sample = torch.tensor(3, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    for name, (h, w, y0, bh, nb, pix) in FRAME_SHAPES.items():
        n = nb * bh * w
        traces = [path._Trace(n, dev, cfg, resort=True, unroll=True,
                              sort_first=False, capture=False)
                  for _ in range(2)]
        for tr in traces:
            for v in tr.bufs[0].values():
                v.fill_(7)
            for v in (tr.bounce, tr.widx, tr.live):
                v.fill_(7)
        FK.raygen(lens, sample, h, w, y0, bh, nb, True, traces[0])
        FK.raygen_plain(lens, sample, h, w, y0, bh, nb, True, traces[1])
        pairs = [(k, traces[0].bufs[0][k], traces[1].bufs[0][k])
                 for k in traces[0].bufs[0]]
        pairs += [(k, getattr(traces[0], k), getattr(traces[1], k))
                  for k in ("bounce", "widx", "live")]
        bad = [k for k, a, b in pairs if not torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)]
        ms = cuda_ms(lambda: FK.raygen(lens, sample, h, w, y0, bh, nb, True,
                                       traces[0]), 20)
        plain_ms = cuda_ms(lambda: FK.raygen_plain(
            lens, sample, h, w, y0, bh, nb, True, traces[1]), 3)
        nbytes, flops = n * RAYGEN_LANE_BYTES, n * RAYGEN_LANE_FLOPS
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FP32 * 1e3
        say("frame", f"raygen {name} ({w}x{h} rows {y0}-{y0 + bh} x {nb}, "
            f"{n} lanes): kernel = plain bit for bit {not bad} {bad}; "
            f"kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms by bytes ({nbytes / 1e6:.1f} MB "
            f"-> {t_bytes:.4f} ms; {flops / 1e9:.3f} GFLOP -> "
            f"{t_ops:.4f} ms); no PyTorch call computes it")
        if bad:
            raise AssertionError(f"raygen {name}: the kernel differs from "
                                 "its plain version")
        if name == "room_1080p":
            timings["raygen"] = dict(ms=ms, plain_ms=plain_ms,
                                     bound_ms=max(t_bytes, t_ops),
                                     bound_by="bytes")
            errs["raygen"] = 0.0

        gen.manual_seed(n)
        acc = torch.rand((bh, w, 4), generator=gen, device=dev)
        rad = torch.rand((n, 3), generator=gen, device=dev) * torch.exp(
            torch.randn((n, 1), generator=gen, device=dev) * 4)
        order = (torch.randperm(n, generator=gen, device=dev) if pix
                 else None)
        row = accumulate_check(f"{name} (seeded pix)" if pix else name,
                               acc, rad, order, nb)
        if name == "room_1080p":
            timings["accumulate"] = row
            errs["accumulate"] = 0.0
        del traces, acc, rad, order

    # room_1080p's own accumulation: the pix of its last resort
    shape, rad, order, nb = CF.record_accumulate(room, lens, cfg)
    gen.manual_seed(1)
    accumulate_check("room_1080p (its own pix)", torch.rand(
        shape, generator=gen, device=dev), rad, order, nb)
    del rad, order

    # the counts, at room_1080p's first full surface launch and scatter
    # and at offline_720p's segment OFFLINE_SEGMENT (every lane launched,
    # few live)
    o_scene, o_lens, opts = offline_cell
    o_cfg = PathConfig(max_bounces=opts.max_bounces,
                       env_samples_per_bounce=opts.env_samples,
                       mesh_samples_per_bounce=opts.mesh_samples)
    launches = {"room_1080p": CS.record_sample(room, lens, cfg)}
    with CS.recording(CS.OFFLINE_SEGMENT) as rec:
        render_sample(o_scene, o_lens, opts.height, opts.width, 0, o_cfg)
    if "scatter" not in rec:
        raise AssertionError(f"offline_720p's sample ran fewer than "
                             f"{CS.OFFLINE_SEGMENT + 1} segments")
    launches[f"offline_720p segment {CS.OFFLINE_SEGMENT}"] = rec
    costs, masks = {}, []
    for cell, rec in launches.items():
        costs[cell] = 0.0
        for key, counter, _, at in CF.COUNTED:
            name, args, kw = rec[key]
            if counter not in kw:
                raise AssertionError(f"{cell} {key} was called without its "
                                     "counter")
            got, plain, summed, mask = CF.count_of(key, args, kw)
            dead = CF.count_of(key, args, kw, dead=True)[:3]
            say("frame", f"counts: {cell} {key}, a mask of {mask.numel()}: "
                f"kernel's {counter} {got}, plain version's {plain}, torch "
                f"sum of the kernel's mask {summed}; every lane dead "
                f"(kernel, plain, sum) {dead}")
            if not got == plain == summed or dead != (0, 0, 0):
                raise AssertionError(f"{cell} {key}: the folded count "
                                     "differs")
            w, wo = CF.time_counts(key, args, kw, 3)
            costs[cell] += w - wo
            say("frame", f"counts: {cell} {key} kernel with its counter "
                f"{w:.4f} ms, without {wo:.4f} ms (min of 3 rounds, cold "
                f"L2)")
            if cell == "room_1080p":
                if key == "surface/full":  # lanes live at the segment's start
                    masks.append(args[at])
                masks.append(mask)
    del launches, rec
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    live = torch.zeros_like(rays)

    def plain_counts():  # the torch reductions the kernels replace
        r = rays + masks[0].sum()
        r = r + masks[1].sum()
        torch.sum(masks[2], dim=0, out=live)
        return r

    plain_ms = cuda_ms(plain_counts, 20)
    library_ms = cuda_ms(lambda: [torch.count_nonzero(m) for m in masks], 20)
    cost = costs["room_1080p"]
    nbytes = sum(m.numel() for m in masks)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    say("frame", "counts of a segment: in the kernels (with - without) "
        + ", ".join(f"{c} {v:.4f} ms" for c, v in costs.items())
        + f"; at room_1080p plain torch reductions {plain_ms:.4f} ms, "
        f"torch.count_nonzero {library_ms:.4f} ms, bound {t_bytes:.5f} ms by"
        f" bytes (the masks, {nbytes / 1e6:.2f} MB)")
    timings["counts"] = dict(ms=cost, plain_ms=plain_ms, bound_ms=t_bytes,
                             bound_by="bytes", library_ms=library_ms)
    errs["counts"] = 0.0
    del masks

    for cell in ("room_1080p", "offline_720p"):
        prof = stage_profiles[cell]
        say_stages("frame", cell, prof)
        camera = prof["camera"]["kernels"]
        raygen = sum(v for k, v in camera.items() if "raygen_kernel" in k)
        others = [k for k in camera if "raygen_kernel" not in k
                  and "FillFunctor" not in k]
        reductions = [k for k in prof["live_count"]["kernels"]
                      if "reduce" in k.lower()]
        # the miss's mask is the kernel's: no torch op in the env range
        env_others = [k for k in prof["env"]["kernels"]
                      if "env_miss_kernel" not in k]
        # the accumulation with the frame's counts: one kernel a sample
        accum = prof["accumulate"]["kernels"]
        summed = sum(v for k, v in accum.items() if "accumulate_kernel" in k)
        accum_others = [k for k in accum if "accumulate_kernel" not in k
                        and "FillFunctor" not in k]
        say("frame", f"{cell}: camera range kernels {camera}; live_count "
            f"range kernels {prof['live_count']['kernels']}; accumulate "
            f"range kernels {accum}; env range kernels "
            f"{prof['env']['kernels']}")
        if (raygen != 1 or others or reductions or env_others or summed != 1
                or accum_others):
            raise AssertionError(f"{cell}: the camera range holds {raygen} "
                                 f"raygen launches and {others}, the "
                                 f"live_count range reductions "
                                 f"{reductions}, the env range "
                                 f"{env_others}, the accumulate range "
                                 f"{summed} accumulations and "
                                 f"{accum_others}")


def graph_cells(scenes, offline_cell, instanced, cfg, dev):
    """The graphs phase's cells: room_184k at 512x512 (one sample, the
    fused path), room_1080p and instanced_1080p through render_spp (one
    sample, the staged path), one offline_720p sample
    (the CLI's render_sample on the glb's scene, max_bounces 1024: the
    looped form), an engine_720p frame (room_184k through the Engine's
    handles, its defaults, a sensor reset before each frame: sample 0
    each time)."""
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.render.renderer import render_sample, render_spp
    from moonshine_tpu_torch.scene import procedural
    from moonshine_tpu_torch.scripts.compare_loop import engine_from_world

    def staged(scene, lens):
        return lambda i: render_spp(scene, lens, HD[0], HD[1], i, 1, cfg)

    o_scene, o_lens, opts = offline_cell
    o_cfg = PathConfig(max_bounces=opts.max_bounces,
                       env_samples_per_bounce=opts.env_samples,
                       mesh_samples_per_bounce=opts.mesh_samples)
    world, room_lens = procedural.room_scene(grid=6, subdivisions=4)
    e = engine_from_world(world, dev)
    h, w = ENGINE_HW
    sensor = e.create_sensor(w, h)
    lens = e.create_lens(room_lens)

    def frame(_):
        e.reset_sensor(sensor)
        return e.render(sensor, lens), None

    room, room_la = scenes["room_184k/default"]
    return {
        "room_184k": lambda i: render_spp(room, room_la, 512, 512, i, 1,
                                          cfg),
        "room_1080p": staged(room, room_la),
        "offline_720p": lambda i: render_sample(
            o_scene, o_lens, opts.height, opts.width, i, o_cfg),
        "engine_720p": frame,
        "instanced_1080p": staged(*instanced),
    }


def capi_phase(dev):
    """The C ABI on the card: the port's library built with g++ and loaded
    in this process with ctypes; native/test_shim.cpp's scene through the
    Msn* calls (an engine on `cuda`, traversal launches counted, its
    sensor against the Engine's render of the same scene and an EXR round
    trip through MsnExrWrite / MsnExrRead); then the port's copy of that
    C++ host built and run as a subprocess, which prints "shim ok"."""
    import ctypes

    import torch

    from moonshine_tpu_torch import capi
    from moonshine_tpu_torch.accel import packet
    from moonshine_tpu_torch.engine.engine import Engine
    from moonshine_tpu_torch.native import build
    from moonshine_tpu_torch.scene.types import Lens

    u32, f32, P = ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p

    class F3(ctypes.Structure):
        _fields_ = [("x", f32), ("y", f32), ("z", f32)]

    class U3(ctypes.Structure):
        _fields_ = [("x", u32), ("y", u32), ("z", u32)]

    class Mat(ctypes.Structure):
        _fields_ = [("m", f32 * 12)]

    class Geo(ctypes.Structure):
        _fields_ = [("mesh", u32), ("material", u32), ("sampled", ctypes.c_bool)]

    class Ext(ctypes.Structure):
        _fields_ = [("width", u32), ("height", u32)]

    class LensC(ctypes.Structure):
        _fields_ = [("origin", F3), ("forward", F3), ("up", F3),
                    ("vfov", f32), ("aperture", f32),
                    ("focus_distance", f32)]

    class MatC(ctypes.Structure):
        _fields_ = [("normal", u32), ("emissive", u32), ("color", u32),
                    ("metalness", u32), ("roughness", u32), ("ior", f32)]

    t0 = time.perf_counter()
    path = build.build_library()
    say("capi", f"{path.relative_to(ROOT)} built in "
        f"{time.perf_counter() - t0:.2f} s (g++, python3-config --embed; "
        f"Python.h at {build.python_headers()})")
    lib = ctypes.CDLL(str(path))
    sig = {"MsnCreate": ([], P), "MsnDestroy": ([P], None),
           "MsnRender": ([P, u32, u32], ctypes.c_bool),
           "MsnCreateMesh": ([P, ctypes.POINTER(F3), ctypes.c_size_t, P,
                              ctypes.c_size_t, P, ctypes.c_size_t,
                              ctypes.POINTER(U3), ctypes.c_size_t], u32),
           "MsnCreateSolidTexture1": ([P, f32], u32),
           "MsnCreateSolidTexture3": ([P, F3], u32),
           "MsnCreateMaterial": ([P, MatC], u32),
           "MsnCreateInstance": ([P, Mat, ctypes.POINTER(Geo),
                                  ctypes.c_size_t, ctypes.c_bool], u32),
           "MsnSetInstanceVisibility": ([P, u32, ctypes.c_bool], None),
           "MsnCreateSensor": ([P, Ext], u32),
           "MsnGetSensorData": ([P, u32], ctypes.POINTER(f32)),
           "MsnGetSensorSampleCount": ([P, u32], u32),
           "MsnCreateLens": ([P, LensC], u32),
           "MsnExrWrite": ([ctypes.c_char_p, ctypes.POINTER(f32), u32, u32,
                            u32], ctypes.c_int),
           "MsnExrRead": ([ctypes.c_char_p,
                           ctypes.POINTER(ctypes.POINTER(f32)),
                           ctypes.POINTER(u32), ctypes.POINTER(u32)],
                          ctypes.c_int),
           "MsnExrFree": ([ctypes.POINTER(f32)], None)}
    for name, (args, res) in sig.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res

    e = lib.MsnCreate()
    if not e:
        raise AssertionError("MsnCreate returned a null engine")
    eng = capi.get_engine(int(e))
    quad = (F3 * 4)(F3(-3, -3, 0), F3(3, -3, 0), F3(3, 3, 0), F3(-3, 3, 0))
    idx = (U3 * 2)(U3(0, 1, 2), U3(0, 2, 3))
    mesh = lib.MsnCreateMesh(e, quad, 4, None, 0, None, 0, idx, 2)
    white = lib.MsnCreateSolidTexture3(e, F3(0.8, 0.8, 0.8))
    black = lib.MsnCreateSolidTexture3(e, F3(0, 0, 0))
    rough = lib.MsnCreateSolidTexture1(e, 1.0)
    metal = lib.MsnCreateSolidTexture1(e, 0.0)
    mat = lib.MsnCreateMaterial(e, MatC(0xFFFFFFFF, black, white, metal,
                                        rough, 1.5))
    ident = Mat((f32 * 12)(1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0))
    geo = Geo(mesh, mat, False)
    inst = lib.MsnCreateInstance(e, ident, ctypes.byref(geo), 1, True)
    sensor = lib.MsnCreateSensor(e, Ext(32, 24))
    lens_c = LensC(F3(0, -4, 2), F3(0, 0.92, -0.38), F3(0, 0, 1), 0.8, 0.0,
                   1.0)
    lens = lib.MsnCreateLens(e, lens_c)
    packet.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(2):
        if not lib.MsnRender(e, sensor, lens):
            raise AssertionError("MsnRender failed")
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 2
    counts = dict(packet.LAUNCHES)
    got = np.ctypeslib.as_array(lib.MsnGetSensorData(e, sensor),
                                shape=(24, 32, 4)).copy()
    say("capi", f"the test_shim scene through Msn* calls: engine on "
        f"{eng.device}, {lib.MsnGetSensorSampleCount(e, sensor)} samples, "
        f"{dt * 1e3:.2f} ms a frame (32x24, max_bounces 1024, NEE off), "
        f"packet launches {counts}, image mean {got.mean():.6f}")
    if eng.device.type != "cuda" or counts["closest_hit"] == 0 or \
            lib.MsnGetSensorSampleCount(e, sensor) != 2:
        raise AssertionError("the ABI's renders did not run on the card")
    ref = Engine(device=dev)
    m = ref.create_mesh(np.ctypeslib.as_array(
        ctypes.cast(quad, ctypes.POINTER(f32)), shape=(4, 3)),
        np.uint32([[0, 1, 2], [0, 2, 3]]))
    tex = [ref.create_solid_texture(v) for v in
           ([0.8, 0.8, 0.8], [0, 0, 0], [1.0], [0.0])]
    rm = ref.create_material(color=tex[0], metalness=tex[3],
                             roughness=tex[2], emissive=tex[1], ior=1.5)
    ref.create_instance(np.float32([[1, 0, 0, 0], [0, 1, 0, 0],
                                    [0, 0, 1, 0]]), [(m, rm, False)])
    rs = ref.create_sensor(32, 24)
    rl = ref.create_lens(Lens(origin=np.float32([0, -4, 2]),
                              forward=np.float32([0, 0.92, -0.38]),
                              up=np.float32([0, 0, 1]), vfov=0.8))
    ref.render(rs, rl)
    want = ref.render(rs, rl)
    same = bool(np.array_equal(got, want))
    say("capi", f"sensor against Engine's render of the same scene on the "
        f"card: bit-equal {same}, max|diff| {np.abs(got - want).max():.3g}")
    if not same:
        raise AssertionError("the ABI's sensor differs from the Engine's")
    WORK.mkdir(parents=True, exist_ok=True)
    exr_path = str(WORK / "capi.exr").encode()
    if lib.MsnExrWrite(exr_path, lib.MsnGetSensorData(e, sensor), 32, 24,
                       4) != 0:
        raise AssertionError("MsnExrWrite failed")
    out = ctypes.POINTER(f32)()
    w, h = u32(), u32()
    if lib.MsnExrRead(exr_path, ctypes.byref(out), ctypes.byref(w),
                      ctypes.byref(h)) != 0:
        raise AssertionError("MsnExrRead failed")
    back = np.ctypeslib.as_array(out, shape=(h.value, w.value, 4)).copy()
    lib.MsnExrFree(out)
    if not np.array_equal(back, got):
        raise AssertionError("the EXR round trip through the ABI differs")
    lib.MsnSetInstanceVisibility(e, inst, False)
    lib.MsnDestroy(e)
    say("capi", "EXR round trip through MsnExrWrite / MsnExrRead exact; "
        "visibility edit and destroy done")

    t0 = time.perf_counter()
    exe = build.build_host([build.NATIVE / "test_shim.cpp"],
                           WORK / "test_shim")
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = subprocess.run([str(exe), str(WORK / "shim.exr")],
                       capture_output=True, text=True, env=build.host_env(),
                       cwd=WORK, timeout=300)
    say("capi", f"C++ host built in {t_host:.2f} s, ran in "
        f"{time.perf_counter() - t0:.2f} s on the card (no MSN_PLATFORM): "
        f"rc {r.returncode}, {r.stdout.strip()!r}")
    if r.returncode != 0 or "shim ok" not in r.stdout:
        raise AssertionError(f"C++ host failed: {r.stderr[-1500:]}")


def main():
    with phase("device"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: this "
                               "smoke run needs a CUDA device")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        say("device", f"torch {torch.__version__} cuda {torch.version.cuda}"
            f" python {sys.version.split()[0]}")
        dev = torch.device("cuda", 0)

    with phase("build"):
        from moonshine_tpu_torch.accel import native, packet, treelet

        for name, lib in native.build_all().items():
            ptxas = [ln.strip() for ln in lib.log.splitlines()
                     if "registers" in ln or "spill" in ln]
            say("build", f"{lib.path.relative_to(ROOT)} in "
                f"{lib.build_seconds:.1f} s; stack capacity "
                f"{getattr(lib, 'stack_capacity', '-')}; "
                + " | ".join(ptxas))

    from moonshine_tpu_torch.integrator import path
    from moonshine_tpu_torch.integrator.path import PathConfig
    from moonshine_tpu_torch.io.exr import read_exr
    from moonshine_tpu_torch.render.camera import LensArrays
    from moonshine_tpu_torch.render.renderer import (
        _render_spp_staged,
        _sample_rays,
        render_spp,
    )
    from moonshine_tpu_torch.scene import procedural

    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    room = lambda: procedural.room_scene(grid=6, subdivisions=4)
    scenes = {}
    with phase("scenes"):
        for name, make, build_env, mode_env in (
                ("flagship", procedural.flagship_scene, {}, {}),
                ("room_184k/default", room, {}, {}),
                ("room_184k/treelet", room, TREELET_ENV,
                 {"MSN_TREELETS": "1"})):
            t0 = time.perf_counter()
            world, lens = make()
            with env(**build_env):
                scene = world.build(dev)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            wb = scene.wide
            with env(**mode_env):
                mode = path._hbm_mode(wb)
            scenes[name] = (scene, LensArrays.from_lens(lens, dev))
            builder = "sah" if scene.num_tris > 50_000 else "karras"
            say("scenes", f"{name}: {scene.num_tris} triangles, {builder} "
                f"build {t_build:.2f} s, {wb.num_nodes} nodes x {wb.width} "
                f"wide, {wb.num_leaves} leaves x {wb.leaf_slots} slots, rows "
                f"{packet.row_bytes(wb)} B vs budget "
                f"{packet.VMEM_SCENE_BUDGET_BYTES} B, mode {mode}, stack "
                f"bound {wb.max_stack}, K {wb.t_roots.shape[0]}")
        if path._hbm_mode(scenes["room_184k/default"][0].wide) != "hbm":
            raise AssertionError("room_184k is not HBM-class")
        with env(MSN_TREELETS="1"):
            if path._hbm_mode(scenes["room_184k/treelet"][0].wide) != \
                    "treelet":
                raise AssertionError("the treelet build does not dispatch "
                                     "to the treelet kernel")

    errs = {}
    with phase("kernels"):
        for name in ("flagship", "room_184k/default"):
            compare_packet(name, *scenes[name], errs)
        compare_treelet(*scenes["room_184k/treelet"], errs)

    launches = {}
    with phase("flagship"):
        scene, lens = scenes["flagship"]
        spp = 8
        render_spp(scene, lens, 512, 512, 0, spp, cfg)  # warm-up
        torch.cuda.synchronize()
        stats = {}
        packet.reset_launch_counts()
        t0 = time.perf_counter()
        acc, rays = render_spp(scene, lens, 512, 512, spp, spp, cfg,
                               stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(packet.LAUNCHES)
        rays = int(rays)
        img = (acc / spp).cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError("flagship image has non-finite pixels")
        if counts["closest_hit"] != stats["segments"]:
            raise AssertionError(f"closest-hit launches {counts} != "
                                 f"segments run {stats['segments']}")
        say("flagship", f"512x512 x {spp} spp: {rays} rays in {dt:.4f} s = "
            f"{rays / dt / 1e6:.3f} Mrays/s, {dt / spp * 1e3:.2f} ms/spp, "
            f"image mean {img.mean():.6f}, launches {counts}, segments "
            f"{stats['segments']}, resort {stats['resort']}")

    with phase("goldens"):
        w, l = procedural.furnace_scene()
        sc = w.build(dev)
        acc, _ = render_spp(sc, LensArrays.from_lens(l, dev), 64, 64, 0, 8,
                            PathConfig(max_bounces=8, env_samples_per_bounce=0,
                                       mesh_samples_per_bounce=0,
                                       unroll=False))
        err = float((acc / 8 - 1.0).abs().max())
        say("goldens", f"furnace 64x64 x 8 spp: max|img-1| = {err:.3g}")
        if not err < 1e-5:
            raise AssertionError("furnace is not 1 everywhere")
        w, l = procedural.mirror_glass_scene()
        sc = w.build(dev)
        acc, _ = render_spp(sc, LensArrays.from_lens(l, dev), 96, 96, 0, 8,
                            PathConfig(max_bounces=6, env_samples_per_bounce=1,
                                       mesh_samples_per_bounce=0))
        gold = read_exr(ROOT / "tests" / "goldens" / "mirror_glass.exr")[
            ..., :3]
        same_image("mirror_glass 96x96 x 8 spp against its golden", "goldens",
                   (acc / 8).cpu().numpy(), gold)

    with phase("room_184k"):
        scene, lens = scenes["room_184k/default"]
        spp = 2
        torch.cuda.reset_peak_memory_stats()
        packet.reset_launch_counts()
        stats = {}
        t0 = time.perf_counter()
        acc, rays = render_spp(scene, lens, 512, 512, 0, spp, cfg,
                               stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rays = int(rays)
        img = (acc / spp).cpu().numpy()
        finite = bool(np.isfinite(img).all())
        say("room_184k", f"512x512 x {spp} spp: {rays} rays in {dt:.4f} s = "
            f"{rays / dt / 1e6:.3f} Mrays/s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, image "
            f"mean {img.mean():.6f}, finite {finite}, path {stats['path']}, "
            f"resort {stats['resort']}, launches {dict(packet.LAUNCHES)}")
        if not finite or min(packet.LAUNCHES.values()) == 0:
            raise AssertionError("room_184k render failed")

    # the main path: each 1080p configuration's counts are set to 0 just
    # before its timed run and read just after
    with phase("room_1080p"):
        img_default, stats, counts = render_1080p(
            "room_1080p", *scenes["room_184k/default"], cfg, resort=True)
        segs = stats["segments"]
        if (counts["closest_hit"] != segs
                or counts["any_hit"] == 0
                or counts["treelet_closest_hit"]
                or counts["treelet_any_hit"]
                or counts["treelet_pending"]
                or counts["surface"] != segs or counts["env_miss"] != segs
                or counts["scatter"] != counts["any_hit"]
                or counts["env_draw"]
                # each sample: the camera rays' two sorted dispatches and
                # a resort before each later segment
                or counts["unsort_lanes"] != 2 * 2
                or counts["sort_lanes"] != counts["unsort_lanes"] + segs - 2
                # a sample's camera rays and accumulation one launch each;
                # every full surface launch and scatter counts
                or counts["raygen"] != 2 or counts["accumulate"] != 2
                or counts["counts"] != 2 * counts["scatter"]):
            raise AssertionError(f"room_1080p launches {counts}, segments "
                                 f"{segs}")
        launches.update({k: counts[k] for k in (
            "closest_hit", "any_hit", "surface", "scatter", "env_miss",
            "sort_lanes", "unsort_lanes", "raygen",
            "accumulate", "counts")})

    with phase("treelet_1080p"):
        with env(MSN_TREELETS="1"):
            img_treelet, stats, counts = render_1080p(
                "treelet_1080p", *scenes["room_184k/treelet"], cfg,
                resort=False)
        if (counts["treelet_closest_hit"] != stats["segments"]
                or counts["treelet_any_hit"] == 0
                or counts["treelet_pending"] != counts["treelet_closest_hit"]
                + counts["treelet_any_hit"]
                or counts["sort_lanes"] != counts["treelet_pending"]
                or counts["unsort_lanes"] != counts["treelet_pending"]
                or counts["closest_hit"] or counts["any_hit"]):
            raise AssertionError(f"treelet_1080p launches {counts}, "
                                 f"segments {stats['segments']}")
        launches.update(treelet_closest_hit=counts["treelet_closest_hit"],
                        treelet_any_hit=counts["treelet_any_hit"],
                        treelet_pending=counts["treelet_pending"])
        same_image("treelet_1080p against room_1080p", "treelet_1080p",
                   img_treelet, img_default)

    with phase("staged_vs_fused"):
        scene, lens = scenes["room_184k/default"]
        fused, _ = render_spp(scene, lens, 512, 512, 0, 1, cfg)
        staged, _ = _render_spp_staged(scene, lens, 512, 512, 0, 1, cfg)
        rel = float(((staged - fused).abs()
                     / fused.abs().clamp_min(1e-30)).max())
        say("staged_vs_fused", f"room_184k 512x512 x 1 spp: bit-equal "
            f"{bool(torch.equal(staged, fused))}, max rel diff {rel:.3g}")
        if rel > 1e-6:
            raise AssertionError("staged and fused paths disagree")

    timings = {}
    with phase("timings"):
        time_kernels(scenes, timings, errs)

    with phase("vpacket"):
        vpacket_phase(scenes, timings, errs, launches)

    with phase("fallback"):
        fallback_phase(scenes, cfg)

    with phase("vpu"):
        vpu_phase(dev, timings, errs, launches)

    with phase("bitcast"):
        bitcast_phase(dev, timings, errs, launches)

    with phase("presplit"):
        presplit_phase(scenes, errs, cfg, dev)

    with phase("offline"):
        offline_cell = offline_phase(dev)

    # the progressive-engine slice: each path's counts set to 0 just
    # before it and read just after
    slice_launches = {}
    with phase("jpeg"):
        jpeg_phase(dev)

    with phase("engine"):
        engine_phase(*procedural.room_scene(grid=6, subdivisions=4), dev,
                     slice_launches)

    with phase("direct"):
        direct_phase(*scenes["room_184k/default"], slice_launches)
        # the env draw's path: a bounce's samples are the surface's now
        launches["env_draw"] = slice_launches["direct_shading"]["env_draw"]

    with phase("sharded"):
        sharded_phase(*scenes["room_184k/default"], dev, slice_launches)

    with phase("viewer"):
        viewer_phase(*procedural.flagship_scene(), dev)
    say("slice", f"packet-kernel launches by path: {slice_launches}")

    # the last slice: two-level instancing (its counts set to 0 just
    # before its 1080p run and read just after) and the C ABI
    with phase("tlas"):
        instanced = tlas_phase(dev, cfg, timings, errs, launches)

    # this slice: the bounce's shading kernels at the 1080p shapes
    with phase("shade"):
        shade_phase({"room_1080p": (*scenes["room_184k/default"], cfg),
                     "instanced_1080p": (*instanced, cfg)}, timings, errs)

    # this slice: the lane sort at the 1080p shapes, the renders with its
    # plain version, and the shadow batch's sort on the card
    with phase("sort"):
        sort_phase(scenes, offline_cell, cfg, timings, errs)

    with phase("shadow_compact"):
        shadow_compact_phase(*scenes["room_184k/default"], cfg)

    stage_profiles = {}
    with phase("graphs"):
        graph_if_phase(dev, timings, errs)
        launches.update(graphs_phase(
            graph_cells(scenes, offline_cell, instanced, cfg, dev),
            stage_profiles))
        del instanced

    # a sample's camera rays, accumulation and counts
    with phase("frame"):
        frame_phase(scenes, offline_cell, stage_profiles, cfg, timings,
                    errs)
        del offline_cell

    with phase("capi"):
        capi_phase(dev)

    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "cuda_kernels": CUDA_KERNELS[k], "launches": launches[k],
         "max_abs_err": errs[k], "library_ms": None, **timings[k]}
        for k, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
