"""DDS (DX10) header parsing (port of moonshine_tpu/io/dds.py; parity:
engine/fileformats/dds.zig:1-83). Headers are parsed and DXGI formats
named, as upstream does; no load path uses them, so block-compressed
assets are identified, not decoded.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

DDS_MAGIC = 0x20534444  # 'DDS '

# DXGI format -> (name, block compressed) for the formats the reference maps
# (dds.zig:51-83)
DXGI_FORMATS = {
    71: ("bc1_rgba_unorm", True),
    72: ("bc1_rgba_srgb", True),
    80: ("bc4_unorm", True),
    81: ("bc4_snorm", True),
    83: ("bc5_unorm", True),
    84: ("bc5_snorm", True),
    95: ("bc6h_ufloat", True),
    96: ("bc6h_sfloat", True),
}


@dataclass
class DdsHeader:
    width: int
    height: int
    mip_count: int
    dxgi_format: int
    format_name: str
    data_offset: int


def parse_header(data: bytes) -> DdsHeader:
    """Parse a DX10-extended DDS header; raises ValueError otherwise."""
    if len(data) < 148:
        raise ValueError("too short for a DX10 DDS file")
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != DDS_MAGIC:
        raise ValueError("not a DDS file")
    size, flags, height, width = struct.unpack_from("<4I", data, 4)
    if size != 124:
        raise ValueError(f"bad DDS header size {size}")
    (mip_count,) = struct.unpack_from("<I", data, 28)
    # pixel format block at offset 76; fourCC at 84
    (fourcc,) = struct.unpack_from("<4s", data, 84)
    if fourcc != b"DX10":
        raise ValueError("only DX10-extended DDS headers supported")
    dxgi, dimension, misc, array_size, misc2 = struct.unpack_from(
        "<5I", data, 128
    )
    if dxgi not in DXGI_FORMATS:
        raise ValueError(f"unmapped DXGI format {dxgi}")
    return DdsHeader(
        width=width,
        height=height,
        mip_count=max(mip_count, 1),
        dxgi_format=dxgi,
        format_name=DXGI_FORMATS[dxgi][0],
        data_offset=148,
    )
