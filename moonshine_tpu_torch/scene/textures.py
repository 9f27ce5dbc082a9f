"""Material texture storage (port of moonshine_tpu/scene/textures.py).

Two independently sized blocks per material, packed channel-wise into two
bf16 atlas planes on the host:

  block A (BSDF maps): 0-2 color | 3 metalness | 4 roughness | 5-6 normal rg
  block B (emissive):  0-2 emissive

Each block carries a one-texel wrap border on its right and bottom edges,
so a bilinear fetch reads the fixed row shifts (+0, +1, +stride,
+stride+1) of its top-left texel. `sample_material_block` does those four
indexed taps in torch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BLOCK_CHANNELS = 8
COLOR = slice(0, 3)
METALNESS = 3
ROUGHNESS = 4
NORMAL_RG = slice(5, 7)
EMISSIVE = slice(0, 3)


class AtlasPlane(NamedTuple):
    data: torch.Tensor  # [H*W + tail, 8] bf16 flat rows
    width: int  # row stride
    chunks: int  # ceil(H*W / 128): 128-row chunks before the tail padding


class MaterialAtlas(NamedTuple):
    bsdf: AtlasPlane
    emissive: AtlasPlane
    # every block of the plane is a 1x1 constant: its values live in the
    # packed material row and shading skips the atlas fetch
    bsdf_constant: bool
    emissive_constant: bool
    # every normal map is the flat (0.5, 0.5): the texture frame is the
    # vertex frame and the integrator skips the normal decode
    normals_flat: bool


def _as_image(source, channels: int) -> np.ndarray:
    """Constant or [h,w,c] image -> [h,w,channels] float32."""
    src = np.asarray(source, np.float32)
    if src.ndim <= 1:
        v = np.broadcast_to(src.reshape(-1)[:channels], (channels,))
        if src.ndim == 0 or src.size < channels:
            v = (np.full(channels, float(src.reshape(-1)[0]), np.float32)
                 if src.size == 1 else np.resize(src, channels))
        return np.asarray(v, np.float32).reshape(1, 1, channels)
    if src.ndim == 2:
        src = src[..., None]
    if src.shape[-1] >= channels:
        return src[..., :channels].astype(np.float32)
    return np.concatenate(
        [src, np.ones((*src.shape[:2], channels - src.shape[-1]),
                      np.float32)], axis=-1)


def _resize_bilinear_wrap(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Upsample with the same repeat-wrap bilinear used at run time."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    ih, iw = img.shape[:2]
    v = (np.arange(h) + 0.5) / h * ih - 0.5
    u = (np.arange(w) + 0.5) / w * iw - 0.5
    v0 = np.floor(v).astype(np.int64)
    u0 = np.floor(u).astype(np.int64)
    fv = (v - v0)[:, None, None]
    fu = (u - u0)[None, :, None]
    v0w, v1w = v0 % ih, (v0 + 1) % ih
    u0w, u1w = u0 % iw, (u0 + 1) % iw
    top = img[v0w][:, u0w] * (1 - fu) + img[v0w][:, u1w] * fu
    bot = img[v1w][:, u0w] * (1 - fu) + img[v1w][:, u1w] * fu
    return top * (1 - fv) + bot * fv


def _pack_block(imgs) -> np.ndarray:
    h = max(im.shape[0] for _, im in imgs)
    w = max(im.shape[1] for _, im in imgs)
    block = np.zeros((h, w, BLOCK_CHANNELS), np.float32)
    for where, im in imgs:
        block[..., where] = _resize_bilinear_wrap(im, h, w)
    return block


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def _pack_plane(blocks) -> tuple[np.ndarray, int, int, np.ndarray]:
    """Shelf-pack blocks into one plane with wrap borders. Returns
    (flat float32 rows [R, 8] incl. tail padding, stride, chunks,
    rects [n, 4] int32 (x, y, w, h))."""
    max_w = max(b.shape[1] for b in blocks) + 1
    atlas_w = max(_next_pow2(max_w), 16)
    total = sum((b.shape[0] + 1) * (b.shape[1] + 1) for b in blocks)
    while atlas_w * atlas_w < total * 1.4 and atlas_w < 16384:
        atlas_w *= 2

    order = sorted(range(len(blocks)), key=lambda i: -blocks[i].shape[0])
    rects = np.zeros((len(blocks), 4), np.int32)
    shelf_x = shelf_y = shelf_h = 0
    for i in order:
        h, w, _ = blocks[i].shape
        if shelf_x + w + 1 > atlas_w:
            shelf_y += shelf_h
            shelf_x, shelf_h = 0, 0
        rects[i] = (shelf_x, shelf_y, w, h)
        shelf_x += w + 1
        shelf_h = max(shelf_h, h + 1)
    atlas_h = _next_pow2(shelf_y + shelf_h)

    data = np.zeros((atlas_h, atlas_w, BLOCK_CHANNELS), np.float32)
    for i, b in enumerate(blocks):
        x, y, w, h = rects[i]
        data[y:y + h, x:x + w] = b
        data[y + h, x:x + w] = b[0]  # bottom wrap border
        data[y:y + h, x + w] = b[:, 0]  # right wrap border
        data[y + h, x + w] = b[0, 0]
    flat = data.reshape(-1, BLOCK_CHANNELS)
    rows = len(flat)
    tail = atlas_w + 1 + 128
    flat = np.concatenate([flat, np.zeros((tail, BLOCK_CHANNELS), np.float32)])
    return flat, atlas_w, -(-rows // 128), rects


def plane_from_rows(flat, width: int, chunks: int, device) -> AtlasPlane:
    """Device plane from host float32 rows (stored as bf16)."""
    return AtlasPlane(
        data=torch.tensor(np.asarray(flat, np.float32),
                          device=device).to(torch.bfloat16),
        width=int(width), chunks=int(chunks),
    )


class MaterialBlockBuilder:
    """Host-side packer: add() appends one material (BSDF block + emissive
    block); build() returns both planes' rows and rects plus constants."""

    def __init__(self):
        self.bsdf_blocks: list[np.ndarray] = []
        self.emissive_blocks: list[np.ndarray] = []
        # per material: color3 | metalness | roughness | emissive3 | normal2
        self.constants: list[np.ndarray] = []
        self.bsdf_textured = False
        self.emissive_textured = False
        self.normals_flat = True

    def add(self, color, metalness, roughness, emissive, normal_rg) -> int:
        nrm = _as_image(normal_rg, 2)
        if nrm.shape[:2] != (1, 1) or not np.all(nrm == 0.5):
            self.normals_flat = False
        a = _pack_block([
            (COLOR, _as_image(color, 3)),
            (slice(METALNESS, METALNESS + 1), _as_image(metalness, 1)),
            (slice(ROUGHNESS, ROUGHNESS + 1), _as_image(roughness, 1)),
            (NORMAL_RG, _as_image(normal_rg, 2)),
        ])
        b = _pack_block([(EMISSIVE, _as_image(emissive, 3))])
        self.bsdf_blocks.append(a)
        self.emissive_blocks.append(b)
        if a.shape[:2] != (1, 1):
            self.bsdf_textured = True
        if b.shape[:2] != (1, 1):
            self.emissive_textured = True
        self.constants.append(np.concatenate([
            a[0, 0, COLOR], a[0, 0, METALNESS:METALNESS + 1],
            a[0, 0, ROUGHNESS:ROUGHNESS + 1], b[0, 0, EMISSIVE],
            a[0, 0, NORMAL_RG],
        ]))
        return len(self.bsdf_blocks) - 1

    def build(self):
        """Returns (planes, rects [n, 2, 4] int32, constants [n, 10] f32).
        planes maps "bsdf"/"emissive" to (flat rows, stride, chunks) and
        the three flags to bools."""
        if not self.bsdf_blocks:
            self.add((1, 1, 1), 0.0, 1.0, (0, 0, 0), (0.5, 0.5))
        *bsdf, rects_a = _pack_plane(self.bsdf_blocks)
        *emissive, rects_b = _pack_plane(self.emissive_blocks)
        planes = dict(bsdf=tuple(bsdf), emissive=tuple(emissive),
                      bsdf_constant=not self.bsdf_textured,
                      emissive_constant=not self.emissive_textured,
                      normals_flat=self.normals_flat)
        return (planes, np.stack([rects_a, rects_b], axis=1),
                np.stack(self.constants))


def sample_material_block(plane: AtlasPlane, rect: torch.Tensor,
                          uv: torch.Tensor) -> torch.Tensor:
    """Bilinear repeat-wrap fetch of whole material blocks from one plane.

    rect: [N, 4] (x, y, w, h) as floats; uv: [N, 2] -> [N, 8] f32. Only the
    top-left tap wraps; the other three are fixed shifts thanks to the
    wrap borders, so the filter is four indexed row reads."""
    x0 = rect[..., 0].to(torch.int64)
    y0 = rect[..., 1].to(torch.int64)
    tw = rect[..., 2]
    th = rect[..., 3]

    u = uv[..., 0] * tw - 0.5
    v = uv[..., 1] * th - 0.5
    iu = torch.floor(u)
    iv = torch.floor(v)
    fu1 = u - iu
    fv1 = v - iv

    iu0 = torch.remainder(iu.to(torch.int32), tw.to(torch.int32))
    iv0 = torch.remainder(iv.to(torch.int32), th.to(torch.int32))

    stride = plane.width
    base = (y0 + iv0) * stride + (x0 + iu0)
    weights = (
        (1 - fu1) * (1 - fv1), fu1 * (1 - fv1), (1 - fu1) * fv1, fu1 * fv1,
    )
    out = 0.0
    for shift, wk in zip((0, 1, stride, stride + 1), weights):
        out = out + wk[:, None] * plane.data[base + shift].to(torch.float32)
    return out
