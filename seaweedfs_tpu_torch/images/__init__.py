"""Image handling: EXIF auto-orientation + on-the-fly resizing.

Reference: weed/images/orientation.go (FixJpgOrientation applied on
JPEG upload, hooked at storage/needle/needle.go:100-105) and
resizing.go (Resized serving ?width=&height=&mode= reads, hooked at
server/volume_server_handlers_read.go:219-243).

PIL backs both; when it's unavailable every function degrades to a
pass-through so storage semantics never depend on it.
"""

from __future__ import annotations

import io

try:
    from PIL import Image, ImageOps
    HAS_PIL = True
except Exception:  # noqa: BLE001 — optional dependency
    HAS_PIL = False

IMAGE_MIMES = ("image/jpeg", "image/png", "image/gif", "image/webp")


def is_image_mime(mime: str) -> bool:
    return mime in IMAGE_MIMES


def fix_jpeg_orientation(data: bytes) -> bytes:
    """Rotate JPEG pixels per the EXIF Orientation tag and strip it
    (orientation.go FixJpgOrientation)."""
    if not HAS_PIL:
        return data
    try:
        img = Image.open(io.BytesIO(data))
        if img.format != "JPEG":
            return data
        exif = img.getexif()
        if exif.get(0x0112, 1) == 1:  # Orientation tag: already upright
            return data
        fixed = ImageOps.exif_transpose(img)
        out = io.BytesIO()
        fixed.save(out, format="JPEG", quality=90)
        return out.getvalue()
    except Exception:  # noqa: BLE001 — corrupt image: store as-is
        return data


def resized(data: bytes, width: int = 0, height: int = 0,
            mode: str = "") -> tuple[bytes, str]:
    """Resize an image read (resizing.go Resized).

    mode '' : preserve aspect ratio within (width, height)
    'fit'   : fit inside the box, padding to exactly (width, height)
    'fill'  : cover the box and center-crop to exactly (width, height)
    Returns (bytes, mime) — unchanged input when no resize applies."""
    if not HAS_PIL or (not width and not height):
        return data, ""
    try:
        img = Image.open(io.BytesIO(data))
        fmt = img.format or "PNG"
        w, h = img.size
        tw = width or w
        th = height or h
        if mode == "fill":
            out_img = ImageOps.fit(img, (tw, th))
        elif mode == "fit":
            out_img = ImageOps.pad(img.convert("RGB")
                                   if fmt == "JPEG" else img, (tw, th))
        else:
            out_img = img.copy()
            out_img.thumbnail((tw, th))
        out = io.BytesIO()
        if fmt == "JPEG" and out_img.mode not in ("RGB", "L"):
            out_img = out_img.convert("RGB")
        out_img.save(out, format=fmt)
        return out.getvalue(), f"image/{fmt.lower()}"
    except Exception:  # noqa: BLE001 — not an image after all
        return data, ""
