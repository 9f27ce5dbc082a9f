"""Persistent progressive rendering engine (port of
moonshine_tpu/engine/engine.py; parity: the hydra/online surface of the
upstream engine, hydra/moonshine.h:72-95).

An Engine owns image/texture handles, materials, meshes, instances,
sensors and lenses on one torch device (the card unless told otherwise).
Edits go through World, whose staged build refits after transform and
visibility edits and rebuilds only the material table after material
edits; `render(sensor, lens, spp)` accumulates progressive samples
through `render_sample`, or through `parallel.render_sharded` when a
mesh is set and the frame divides it. `pick` traces one camera ray,
sensors checkpoint to `np.savez` files that both packages read.

Two locks, as in the reference: `_render_lock` serialises frames, and
`_lock` guards the engine's state, held only to snapshot and to commit
around a frame's device work, so picks, edits and status reads from
other threads (the viewer's HTTP handlers) stay responsive. On a CUDA
device a pick runs on a stream of its own, which waits for the scene's
upload but not for the frames queued on the default stream.

`render(..., wait=False)` returns without reading the frame back. The
bounce loop chooses its live prefixes and its stop on the device (CUDA
graph IF nodes, integrator/graphs.py); its looped form (max_bounces + 2
> 10, the default's 1024) still reads the live count on the host once a
block of path.LOOP_BLOCK segments, so the call returns when the frame's
last block is queued, a few reads before its end; the unrolled form
reads nothing, and the call returns once the frame is queued. On a card each segment is a CUDA graph replay
(integrator/graphs.py), captured under the frame lock at a frame's
first use; a scene edit gives new graphs. Captures run in the
thread-local error mode, so a pick during a capture is neither captured
nor an error.
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..core.mathutil import INF_T
from ..integrator.path import PathConfig, _closest
from ..render.camera import LensArrays, generate_rays, pixel_uv
from ..render.renderer import render_sample
from ..render.sensor import Sensor, accumulate
from ..scene.types import Geometry, Instance, Lens, MaterialInfo, Mesh
from ..scene.types import StandardPBR
from ..scene.world import World


@dataclass
class _EngineMaterial:
    """Image-handle material record (moonshine.h Material)."""

    normal: int | None
    emissive: int
    color: int
    metalness: int
    roughness: int
    ior: float


@dataclass
class PickResult:
    instance: int  # -1 on a miss
    geometry: int
    primitive: int
    barycentrics: tuple[float, float]

    @property
    def hit(self) -> bool:
        return self.instance >= 0


class Engine:
    """Thread-safe progressive engine on one device."""

    def __init__(self, config: PathConfig | None = None, device="cuda"):
        self.device = torch.device(device)
        self._lock = threading.RLock()
        self._render_lock = threading.Lock()
        self._sensor_gen: dict = {}  # sensor -> generation (bumped on reset)
        self.world = World()
        self.images: list = []
        self._materials: list[_EngineMaterial] = []
        self.sensors: list[Sensor] = []
        self.lenses: list[Lens] = []
        # the hydra pipeline's defaults (hydra.zig:95-105): deep bounces,
        # NEE off
        self.config = config or PathConfig(
            max_bounces=1024, env_samples_per_bounce=0,
            mesh_samples_per_bounce=0)
        self._scene = None
        self._scene_ready = None  # CUDA event after the scene's upload
        self._pick_stream = None
        self._dirty = True
        self._pending_rays: list = []  # ray counts of wait=False frames
        self._mesh = None
        self._mesh_fallback_warned = False
        self.metrics: dict = {"renders": 0, "rays": 0.0,
                              "render_seconds": 0.0}

    def set_mesh(self, mesh_or_spec) -> None:
        """Render on a device mesh: a parallel.Mesh, or a spec ("auto",
        "SP,DP") resolved against this engine's kind of device. Frames
        whose height divides by dp and spp by sp go through
        parallel.render_sharded, others through one device (with one
        warning). None turns it off."""
        if isinstance(mesh_or_spec, str):
            from ..parallel import mesh_from_spec

            mesh_or_spec = mesh_from_spec(mesh_or_spec, self.device)
        if mesh_or_spec is not None:
            names = tuple(getattr(mesh_or_spec, "axis_names", ()))
            if "sp" not in names or "dp" not in names:
                raise ValueError(
                    "mesh must have 'sp' and 'dp' axes (use "
                    f"parallel.make_mesh / mesh_from_spec); got {names}")
        with self._lock:
            self._mesh = mesh_or_spec
            self._mesh_fallback_warned = False

    # --- images (moonshine.h CreateSolidTexture* / CreateRawTexture) ---

    def create_solid_texture(self, value) -> int:
        with self._lock:
            self.images.append(np.asarray(value, np.float32).reshape(1, 1, -1))
            self._dirty = True
            return len(self.images) - 1

    def create_raw_texture(self, pixels: np.ndarray, srgb: bool = False) -> int:
        """pixels: [h, w, c] float in [0, 1] or uint8; srgb decodes to
        linear (the reference's u8x4_srgb format)."""
        img = np.asarray(pixels)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if srgb:
            from ..scene.gltf import srgb_to_linear

            img = img.copy()
            img[..., :3] = srgb_to_linear(img[..., :3])
        with self._lock:
            self.images.append(img)
            self._dirty = True
            return len(self.images) - 1

    # --- meshes (moonshine.h CreateMesh) ---

    def create_mesh(self, positions, indices, normals=None, texcoords=None,
                    indexed_attributes: bool = True) -> int:
        with self._lock:
            handle = self.world.add_mesh(Mesh(
                positions=np.asarray(positions, np.float32),
                indices=np.asarray(indices, np.uint32),
                normals=(None if normals is None
                         else np.asarray(normals, np.float32)),
                texcoords=(None if texcoords is None
                           else np.asarray(texcoords, np.float32)),
                indexed_attributes=indexed_attributes))
            self._dirty = True
            return handle

    # --- materials (moonshine.h CreateMaterial + SetMaterial*) ---

    def create_material(self, color: int, metalness: int, roughness: int,
                        emissive: int, normal: int | None = None,
                        ior: float = 1.5) -> int:
        """StandardPBR from image handles (the one variant hydra exposes,
        hydra.zig:423-433)."""
        with self._lock:
            rec = _EngineMaterial(normal=normal, emissive=emissive,
                                  color=color, metalness=metalness,
                                  roughness=roughness, ior=ior)
            self._materials.append(rec)
            handle = self.world.add_material(self._to_info(rec))
            self._dirty = True
            return handle

    def _to_info(self, rec: _EngineMaterial) -> MaterialInfo:
        img = lambda h: self.images[h]
        return MaterialInfo(
            variant=StandardPBR(color=img(rec.color),
                                metalness=img(rec.metalness),
                                roughness=img(rec.roughness), ior=rec.ior),
            normal=None if rec.normal is None else img(rec.normal)[..., :2],
            emissive=img(rec.emissive))

    def _set_material(self, handle: int, **updates) -> None:
        with self._lock:
            rec = self._materials[handle]
            for k, v in updates.items():
                setattr(rec, k, v)
            self.world.update_material(handle, self._to_info(rec))
            self._dirty = True

    def set_material_normal(self, handle: int, image: int):
        self._set_material(handle, normal=image)

    def set_material_emissive(self, handle: int, image: int):
        self._set_material(handle, emissive=image)

    def set_material_color(self, handle: int, image: int):
        self._set_material(handle, color=image)

    def set_material_metalness(self, handle: int, image: int):
        self._set_material(handle, metalness=image)

    def set_material_roughness(self, handle: int, image: int):
        self._set_material(handle, roughness=image)

    def set_material_ior(self, handle: int, ior: float):
        self._set_material(handle, ior=ior)

    # --- instances (moonshine.h Create/DestroyInstance, SetTransform) ---

    def create_instance(self, transform, geometries, visible=True) -> int:
        with self._lock:
            handle = self.world.add_instance(Instance(
                transform=np.asarray(transform, np.float32),
                geometries=[g if isinstance(g, Geometry) else Geometry(*g)
                            for g in geometries],
                visible=visible))
            self._dirty = True
            return handle

    def destroy_instance(self, handle: int):
        """Hides the instance, as the reference does (hydra.zig:497-500)."""
        self.set_instance_visibility(handle, False)

    def set_instance_transform(self, handle: int, transform):
        with self._lock:
            self.world.set_transform(handle, transform)
            self._dirty = True

    def set_instance_visibility(self, handle: int, visible: bool):
        with self._lock:
            self.world.set_visibility(handle, visible)
            self._dirty = True

    # --- backgrounds ---

    def set_background(self, equirect_rgb: np.ndarray | None, size=None):
        with self._lock:
            self.world.set_background(equirect_rgb, size)
            self._dirty = True

    def add_background(self, equirect_rgb: np.ndarray | None,
                       size=None) -> int:
        """Register an env map without selecting it."""
        with self._lock:
            return self.world.add_background(equirect_rgb, size)

    def use_background(self, handle: int):
        """Switch the active env map (each is built once)."""
        with self._lock:
            self.world.use_background(handle)
            self._dirty = True

    # --- sensors / lenses (moonshine.h CreateSensor / CreateLens) ---

    def create_sensor(self, width: int, height: int) -> int:
        with self._lock:
            self.sensors.append(Sensor.create(height, width, self.device))
            return len(self.sensors) - 1

    def reset_sensor(self, handle: int):
        """Restart accumulation (Sensor.clear)."""
        with self._lock:
            self.sensors[handle] = self.sensors[handle].clear()
            self._sensor_gen[handle] = self._sensor_gen.get(handle, 0) + 1

    def get_sensor_data(self, handle: int) -> np.ndarray:
        """[H, W, 4] float32 RGBA running mean (GetSensorData)."""
        with self._lock:
            img = self.sensors[handle].image.cpu().numpy()
        return np.concatenate(
            [img, np.ones((*img.shape[:2], 1), np.float32)], axis=-1)

    def sample_count(self, handle: int) -> int:
        return int(self.sensors[handle].sample_count)

    def create_lens(self, lens: Lens) -> int:
        with self._lock:
            self.lenses.append(lens)
            return len(self.lenses) - 1

    def set_lens(self, handle: int, lens: Lens):
        """Replace a lens; sensors keep accumulating (hydra resets them
        itself)."""
        with self._lock:
            self.lenses[handle] = lens

    def set_config(self, config: PathConfig):
        """New integrator knobs, used from the next frame on (the
        reference's pipeline rebuild)."""
        with self._lock:
            self.config = config

    # --- scene ---

    def _ensure_scene(self):
        if self._dirty or self._scene is None:
            scene = self.world.build(self.device)
            if scene is not self._scene and self.device.type == "cuda":
                self._scene_ready = torch.cuda.Event()
                self._scene_ready.record(
                    torch.cuda.current_stream(self.device))
            self._scene = scene
            self._dirty = False
        return self._scene

    # --- render (moonshine.h HdMoonshineRender) ---

    def render(self, sensor: int, lens: int, spp: int = 1,
               wait: bool = True) -> np.ndarray | None:
        """Accumulate spp progressive samples into the sensor.

        wait=True blocks until the frame is on the host and returns it
        (get_sensor_data). wait=False returns None without reading the
        frame back: with the looped bounce loop (the default max_bounces)
        it waits for the live count of each block of path.LOOP_BLOCK
        segments but the last, with the unrolled one for nothing (the
        module docstring); its rays are counted at the next waited
        frame."""
        with self._render_lock:
            with self._lock:
                scene = self._ensure_scene()
                s = self.sensors[sensor]
                gen = self._sensor_gen.get(sensor, 0)
                lens_arrays = LensArrays.from_lens(self.lenses[lens],
                                                   self.device)
                cfg = self.config
                mesh = self._mesh
            h, w = s.image.shape[:2]
            t0 = time.perf_counter()
            rays_parts = []
            use_mesh = (mesh is not None and h % mesh.shape["dp"] == 0
                        and spp % mesh.shape["sp"] == 0)
            if mesh is not None and not use_mesh:
                with self._lock:
                    warn = not self._mesh_fallback_warned
                    self._mesh_fallback_warned = True
                if warn:
                    warnings.warn(
                        f"device mesh set (sp={mesh.shape['sp']}, "
                        f"dp={mesh.shape['dp']}) but height {h} % dp or "
                        f"spp {spp} % sp != 0: rendering single-device. "
                        "Pick dividing shapes to use the mesh.",
                        RuntimeWarning, stacklevel=2)
            if use_mesh:
                from .. import parallel

                img, rays = parallel.render_sharded(
                    scene, lens_arrays, h, w, spp, cfg, mesh,
                    flip_image=False, base_sample=s.sample_count)
                s = accumulate(s, img * spp, spp)
                rays_parts.append(rays)
            else:
                for _ in range(spp):
                    img, rays = render_sample(scene, lens_arrays, h, w,
                                              s.sample_count, cfg, False)
                    s = accumulate(s, img, 1)
                    rays_parts.append(rays)
            if not wait:
                with self._lock:
                    if self._sensor_gen.get(sensor, 0) == gen:
                        self.sensors[sensor] = s
                        self._pending_rays.extend(rays_parts)
                    self.metrics["renders"] += 1
                return None
            rays_now = float(sum(int(r) for r in rays_parts))
            s.image.cpu()  # the frame is done (outside the engine lock)
            dt = time.perf_counter() - t0
            with self._lock:
                if self._sensor_gen.get(sensor, 0) == gen:
                    # a reset_sensor during the frame discards it
                    self.sensors[sensor] = s
                rays_pending = float(sum(int(r) for r in self._pending_rays))
                self._pending_rays.clear()
                self.metrics["renders"] += 1
                self.metrics["rays"] += rays_now + rays_pending
                self.metrics["render_seconds"] += dt
                self.metrics["last_frame_seconds"] = dt
                self.metrics["last_mrays_per_sec"] = rays_now / dt / 1e6
        return self.get_sensor_data(sensor)

    # --- object picking (ObjectPicker.zig:89-128) ---

    def pick(self, lens: int, width: int, height: int, x: int,
             y: int) -> PickResult:
        """Trace the camera ray through pixel (x, y) (no jitter, no
        aperture, no flip); returns the hit's instance, geometry and
        primitive (tri_shade columns 26-28; on a two-level scene the
        instance comes with the hit) and barycentrics."""
        with self._lock:
            scene = self._ensure_scene()
            lens_arrays = LensArrays.from_lens(self.lenses[lens],
                                               self.device)
            if self.device.type != "cuda":
                return self._pick(scene, lens_arrays, width, height, x, y)
            if self._pick_stream is None:
                self._pick_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._pick_stream):
                self._pick_stream.wait_event(self._scene_ready)
                return self._pick(scene, lens_arrays, width, height, x, y)

    def _pick(self, scene, lens_arrays, width, height, x, y) -> PickResult:
        dev = self.device
        px = torch.tensor([x], dtype=torch.int64, device=dev)
        py = torch.tensor([y], dtype=torch.int64, device=dev)
        uv = pixel_uv(px, py, width, height,
                      torch.full((1, 2), 0.5, device=dev), False)
        o, d = generate_rays(lens_arrays, width, height, uv,
                             torch.zeros((1, 2), device=dev))
        hit = _closest(scene, o, d, INF_T, None)
        tri = int(hit.tri[0])  # waits for this stream only
        if tri < 0:
            return PickResult(-1, -1, -1, (0.0, 0.0))
        row = scene.tri_shade[tri].cpu().numpy()
        # a two-level scene's rows are shared (column 26 is -1): its hits
        # carry the instance
        instance = int(row[26] if hit.inst is None else hit.inst[0])
        return PickResult(instance=instance, geometry=int(row[27]),
                          primitive=int(row[28]),
                          barycentrics=(float(hit.u[0]), float(hit.v[0])))

    # --- checkpoints (np.savez, the reference's format) ---

    def save_checkpoint(self, path, sensor: int):
        with self._lock:
            s = self.sensors[sensor]
            np.savez(path, image=s.image.cpu().numpy(),
                     sample_count=int(s.sample_count))

    def load_checkpoint(self, path, sensor: int):
        with self._lock:
            data = np.load(path)
            self.sensors[sensor] = Sensor(
                image=torch.tensor(np.asarray(data["image"], np.float32),
                                   device=self.device),
                sample_count=int(data["sample_count"]))
            self._sensor_gen[sensor] = self._sensor_gen.get(sensor, 0) + 1
