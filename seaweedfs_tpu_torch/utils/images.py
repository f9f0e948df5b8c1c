"""On-the-fly image resize/crop for blob reads.

Port of seaweedfs_tpu/utils/images.py, whole: the same PIL calls give the
same bytes.

Reference: weed/images/resizing.go + orientation.go, invoked from the
volume read handler (volume_server_handlers_read.go:362-421) when a
GET carries ?width/?height. Modes follow the reference:

  (none) : fit within width x height, keep aspect ratio
  fit    : same, but also scale up small images
  fill   : cover width x height then center-crop to exactly that size

JPEG EXIF orientation is normalized before resizing, like the
reference's FixJpgOrientation.
"""

from __future__ import annotations

import io

_MAGIC = {
    b"\xff\xd8\xff": "JPEG",
    b"\x89PNG": "PNG",
    b"GIF8": "GIF",
}


def detect_format(data: bytes) -> str | None:
    for magic, fmt in _MAGIC.items():
        if data[: len(magic)] == magic:
            return fmt
    return None


def resized(
    data: bytes, width: int = 0, height: int = 0, mode: str = ""
) -> tuple[bytes, int, int]:
    """Returns (bytes, w, h); input unchanged when it is not an image,
    no dimensions were asked for, or decoding fails (serving the
    original beats a 500 — reference behavior)."""
    fmt = detect_format(data)
    if fmt is None or (width <= 0 and height <= 0):
        return data, 0, 0
    try:
        from PIL import Image, ImageOps

        img = Image.open(io.BytesIO(data))
        img.load()
        if fmt == "JPEG":
            img = ImageOps.exif_transpose(img)
        ow, oh = img.size
        w, h = width or ow, height or oh
        if mode == "fill":
            img = ImageOps.fit(img, (w, h))
        else:
            if mode != "fit" and w >= ow and h >= oh:
                return data, ow, oh  # default mode never upscales
            ratio = min(w / ow, h / oh)
            img = img.resize(
                (max(1, round(ow * ratio)), max(1, round(oh * ratio)))
            )
        out = io.BytesIO()
        save_fmt = fmt if fmt != "GIF" else "PNG"
        if save_fmt == "JPEG" and img.mode not in ("RGB", "L"):
            img = img.convert("RGB")
        img.save(out, save_fmt)
        return out.getvalue(), img.size[0], img.size[1]
    except Exception:
        return data, 0, 0
