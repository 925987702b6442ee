"""Binary PPM (P6) reader/writer (a copy of tryraytrace_tpu/io/ppm.py).

Parity targets: the reference's hand-rolled reader (renderer.cu:36-76)
and writer (image_io.cpp:73-86).  The reader accepts the same subset:
ASCII magic ``P6``, whitespace-separated width/height/maxval, a single
whitespace byte, then raw RGB24.  We additionally skip ``#`` comments
(a strict superset; the reference would choke on them).
"""

from __future__ import annotations

import numpy as np


def _read_token(buf: bytes, pos: int) -> tuple[bytes, int]:
    n = len(buf)
    while pos < n:
        c = buf[pos : pos + 1]
        if c == b"#":  # comment to end of line
            while pos < n and buf[pos : pos + 1] not in (b"\n", b"\r"):
                pos += 1
        elif c.isspace():
            pos += 1
        else:
            break
    start = pos
    while pos < n and not buf[pos : pos + 1].isspace():
        pos += 1
    return buf[start:pos], pos


def load_ppm(path) -> np.ndarray:
    """Load a binary P6 PPM. Returns uint8 array [H, W, 3].

    Raises ValueError on malformed files (the reference prints and
    returns NULL; callers here surface the error).
    """
    with open(path, "rb") as f:
        buf = f.read()
    magic, pos = _read_token(buf, 0)
    if magic != b"P6":
        raise ValueError(f"Not a P6 binary PPM: {path}")
    w_tok, pos = _read_token(buf, pos)
    h_tok, pos = _read_token(buf, pos)
    max_tok, pos = _read_token(buf, pos)
    w, h, max_val = int(w_tok), int(h_tok), int(max_tok)
    if max_val <= 0 or max_val > 255:
        raise ValueError(f"Unsupported PPM maxval {max_val}: {path}")
    pos += 1  # the single whitespace byte after maxval (renderer.cu:59)
    need = w * h * 3
    data = buf[pos : pos + need]
    if len(data) != need:
        raise ValueError(f"Unexpected EOF in PPM: {path}")
    return np.frombuffer(data, dtype=np.uint8).reshape(h, w, 3)


def save_ppm(path, img: np.ndarray) -> None:
    """Write uint8 [H, W, 3] as binary P6 (image_io.cpp:73-86)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def save_image(path, img: np.ndarray) -> None:
    """Write uint8 [H, W, 3] by path suffix: ``.ppm`` (and anything
    unrecognized) uses the reference-parity P6 writer; ``.png`` /
    ``.jpg`` / ``.jpeg`` / ``.bmp`` go through PIL (the reference only
    ever writes P6, image_io.cpp:73-86)."""
    suffix = str(path).lower().rsplit(".", 1)[-1]
    if suffix in ("png", "jpg", "jpeg", "bmp"):
        from PIL import Image

        Image.fromarray(np.ascontiguousarray(img, dtype=np.uint8)).save(path)
        return
    save_ppm(path, img)
