"""Frozen copy of tests/glb_builder.py at commit 747dbd6 (its
`build_glb`): a minimal binary glTF writer, kept here so that a later
change to the tests cannot move the benchmark's inputs."""

import json
import struct

import numpy as np


def build_glb(meshes, materials, nodes, cameras=None, images=None):
    """meshes: list of dicts {positions [V,3], indices [F,3], normals?,
    texcoords?, material: int}; materials: list of glTF material dicts;
    nodes: list of dicts {mesh: int | camera: int, translation?, matrix?,
    rotation?, scale?}; images: list of PNG bytes."""
    binary = bytearray()
    buffer_views = []
    accessors = []

    def add_data(arr, target=None):
        arr = np.ascontiguousarray(arr)
        while len(binary) % 4:
            binary.append(0)
        offset = len(binary)
        binary.extend(arr.tobytes())
        bv = {"buffer": 0, "byteOffset": offset, "byteLength": arr.nbytes}
        if target:
            bv["target"] = target
        buffer_views.append(bv)
        return len(buffer_views) - 1

    def add_accessor(arr, comp_type, type_str, target=None):
        bv = add_data(arr, target)
        accessors.append(
            {
                "bufferView": bv,
                "componentType": comp_type,
                "count": len(arr),
                "type": type_str,
                "max": np.asarray(arr, np.float64).max(0).tolist()
                if type_str != "SCALAR"
                else [float(np.max(arr))],
                "min": np.asarray(arr, np.float64).min(0).tolist()
                if type_str != "SCALAR"
                else [float(np.min(arr))],
            }
        )
        return len(accessors) - 1

    gltf_meshes = []
    for m in meshes:
        attrs = {
            "POSITION": add_accessor(
                np.asarray(m["positions"], np.float32), 5126, "VEC3", 34962
            )
        }
        if m.get("normals") is not None:
            attrs["NORMAL"] = add_accessor(
                np.asarray(m["normals"], np.float32), 5126, "VEC3", 34962
            )
        if m.get("texcoords") is not None:
            attrs["TEXCOORD_0"] = add_accessor(
                np.asarray(m["texcoords"], np.float32), 5126, "VEC2", 34962
            )
        idx = np.asarray(m["indices"], np.uint16).reshape(-1)
        prim = {
            "attributes": attrs,
            "indices": add_accessor(idx[:, None], 5123, "SCALAR", 34963),
            "material": m.get("material", 0),
        }
        gltf_meshes.append({"primitives": [prim]})

    gltf_images = []
    gltf_textures = []
    for png in images or []:
        bv = add_data(np.frombuffer(png, np.uint8))
        gltf_images.append({"bufferView": bv, "mimeType": "image/png"})
        gltf_textures.append({"source": len(gltf_images) - 1})

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "materials": materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(binary)}],
    }
    if cameras:
        doc["cameras"] = cameras
    if gltf_images:
        doc["images"] = gltf_images
        doc["textures"] = gltf_textures

    json_bytes = json.dumps(doc).encode()
    json_bytes += b" " * (-len(json_bytes) % 4)
    while len(binary) % 4:
        binary.append(0)

    total = 12 + 8 + len(json_bytes) + 8 + len(binary)
    out = bytearray()
    out += struct.pack("<4sII", b"glTF", 2, total)
    out += struct.pack("<I4s", len(json_bytes), b"JSON") + json_bytes
    out += struct.pack("<I4s", len(binary), b"BIN\x00") + bytes(binary)
    return bytes(out)
