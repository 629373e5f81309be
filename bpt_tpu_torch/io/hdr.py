"""Radiance RGBE (.hdr) reader and writer, numpy only.

A copy of ``bpt_tpu.io.hdr`` (importing that module would load jax through
``bpt_tpu/__init__.py``): ``read_hdr`` decodes the RADIANCE header, new-style
RLE and flat scanlines to (H, W, 3) float32; ``write_hdr`` encodes an
uncompressed file.
"""

from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))  # 2^(e-128) / 256
    return (rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32)).astype(
        np.float32
    )


def read_hdr(path: str) -> np.ndarray:
    """Decode a Radiance .hdr file to an (H, W, 3) float32 array."""
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break  # blank line ends header
    # resolution line, e.g. b"-Y 1024 +X 2048"
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported resolution line: {res}")
    height, width = int(res[1]), int(res[3])

    out = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and bp + 4 <= buf.size
            and buf[bp] == 2
            and buf[bp + 1] == 2
            and ((int(buf[bp + 2]) << 8) | int(buf[bp + 3])) == width
        ):
            # new-style RLE: 4 separated channel streams per scanline
            bp += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[bp])
                    bp += 1
                    if count > 128:  # run
                        out[y, x : x + count - 128, c] = buf[bp]
                        bp += 1
                        x += count - 128
                    else:  # literal
                        out[y, x : x + count, c] = buf[bp : bp + count]
                        bp += count
                        x += count
        else:
            # flat scanline
            row = buf[bp : bp + width * 4].reshape(width, 4)
            out[y] = row
            bp += width * 4
    return _rgbe_to_float(out)


def write_hdr(path: str, image: np.ndarray) -> None:
    """Encode (H, W, 3) float32 RGB as an uncompressed .hdr (test fixture aid)."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    maxc = image.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w, 3), np.float32)
    nz = maxc > 1e-38
    exp[nz] = np.ceil(np.log2(maxc[nz])).astype(np.int32) + 1
    scale = np.where(nz, np.ldexp(1.0, -exp) * 256.0, 0.0)
    mant = np.clip(image * scale[..., None], 0, 255)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = mant.astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
