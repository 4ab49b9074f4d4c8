"""Image decode and encode without cv2 (the port's counterpart of the JAX
package's ``cv2.imread`` / ``cv2.imwrite``).

``read_image(path)`` returns RGB uint8 [H, W, 3], as ``cv2.imread`` followed
by ``COLOR_BGR2RGB`` does: gray is replicated to three channels and an alpha
channel is dropped, not composited. Where PIL imports it decodes every
format. Without PIL the reader here takes PNG (8-bit gray, gray+alpha, RGB,
RGBA and palette, non-interlaced, all five row filters), binary PPM/PGM and
``.npy``; anything else, JPEG included, raises and names PIL: nothing is
returned that is not the file's own pixels.

``write_png(path, rgb)`` writes an 8-bit RGB (or gray) PNG with filter 0.

The ``cv2.imread`` / ``cv2.imwrite`` counterparts of the apps and the etl
tools: ``read_bgr`` (BGR, ``None`` where cv2 returns ``None``: a missing or
undecodable file), ``read_gray`` (``IMREAD_GRAYSCALE``: a gray file's own
values; colour reduced as cv2's decoders reduce it: libjpeg's luminance for
JPEG, libpng's truncating 15-bit weights 9797/19234/3737 for PNG, OpenCV's
14-bit 4899/9617/1868 for BMP, ``cvtColor``'s weights otherwise),
``write_image`` (PNG by ``write_png``, anything else through PIL, JPEG at
cv2's quality 95) and ``image_size`` (the header only). With PIL the EXIF
orientation is applied, as ``cv2.imread`` applies it.

PNG rows decode with numpy: None, Sub (a cumulative sum per channel) and Up
(a sum with the row above) row by row; images with Average or Paeth rows,
whose bytes depend on their left neighbour through a rounding, along
anti-diagonals: pixel (r, x) waits for (r, x-1), (r-1, x) and (r-1, x-1),
so every pixel with x + 2r = t decodes together at step t.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_PIL = None  # the PIL.Image module once imported, False where it does not import


def _pil():
    global _PIL
    if _PIL is None:
        try:
            from PIL import Image

            _PIL = Image
        except ImportError:
            _PIL = False
    return _PIL or None


def decoder_name() -> str:
    """Which decoder ``read_image`` uses here."""
    pil = _pil()
    if pil is not None:
        import PIL

        return f"PIL {PIL.__version__}"
    return "builtin (zlib + numpy: png, ppm/pgm, npy)"


def _to_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):  # gray (+ alpha)
        img = np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3], dtype=np.uint8)


def _decode(path: Path) -> np.ndarray:
    """[H, W, C] uint8 in the file's own channels (C 1 gray, 2 gray+alpha,
    3 RGB, 4 RGBA; other PIL modes as RGB)."""
    if path.suffix.lower() == ".npy":
        return np.load(path)
    if _pil() is not None:
        from PIL import ImageOps

        with _pil().open(path) as raw:
            im = ImageOps.exif_transpose(raw)  # a loaded copy, turned as cv2 turns it
        if im.mode not in ("L", "LA", "RGB", "RGBA"):
            im = im.convert("RGB")
        return np.array(im, np.uint8)
    head = path.read_bytes()[:8]
    if head == _PNG_SIG:
        return read_png(path)
    if head[:2] in (b"P5", b"P6"):
        return read_pnm(path)
    raise RuntimeError(f"cannot decode {path} without PIL: the built-in reader takes PNG, "
                       "PPM/PGM and .npy; install PIL (Pillow) for JPEG and other formats")


def read_image(path) -> np.ndarray:
    """RGB uint8 [H, W, 3] of the image at ``path`` (see the module doc)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    return _to_rgb(_decode(path))


def _decoded_or_none(path: Path):
    """``_decode``, or None for a missing or undecodable file (cv2.imread's
    None). A format that needs PIL where PIL is missing still raises."""
    if not path.is_file():
        return None
    try:
        return _decode(path)
    except (OSError, ValueError, EOFError):  # PIL's UnidentifiedImageError is an OSError
        return None


def read_bgr(path):
    """``cv2.imread(path)``: BGR uint8 [H, W, 3], or None."""
    img = _decoded_or_none(Path(path))
    return None if img is None else np.ascontiguousarray(_to_rgb(img)[..., ::-1])


def read_gray(path):
    """``cv2.imread(path, IMREAD_GRAYSCALE)``: uint8 [H, W], or None (the
    colour rules are in the module doc)."""
    path = Path(path)
    if _pil() is not None and path.is_file() and path.suffix.lower() in (".jpg", ".jpeg"):
        from PIL import ImageOps

        try:  # libjpeg decodes the luminance alone, as it does for cv2
            with _pil().open(path) as im:
                im.draft("L", im.size)
                im.load()
                return np.asarray(ImageOps.exif_transpose(im).convert("L"), np.uint8)
        except (OSError, ValueError, EOFError):
            return None
    img = _decoded_or_none(path)
    if img is None:
        return None
    if img.ndim == 2 or img.shape[2] in (1, 2):
        return np.ascontiguousarray(img.reshape(*img.shape[:2], -1)[..., 0])
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    suffix = path.suffix.lower()
    if suffix == ".png":  # libpng's png_set_rgb_to_gray(0.299, 0.587)
        return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    if suffix == ".bmp":  # OpenCV's own BMP decoder: 14-bit weights, rounded
        return ((4899 * r + 9617 * g + 1868 * b + (1 << 13)) >> 14).astype(np.uint8)
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).astype(np.uint8)


def write_image(path, img_bgr: np.ndarray) -> None:
    """``cv2.imwrite(path, img_bgr)`` (BGR [H, W, 3] or gray [H, W] uint8):
    PNG by ``write_png``; any other format through PIL (JPEG at quality 95,
    cv2's default), raising and naming PIL where it does not import."""
    path = Path(path)
    img = np.ascontiguousarray(img_bgr[..., ::-1] if img_bgr.ndim == 3 else img_bgr, np.uint8)
    if path.suffix.lower() == ".png":
        write_png(path, img)
        return
    pil = _pil()
    if pil is None:
        raise RuntimeError(f"cannot write {path} without PIL: the built-in writer takes PNG "
                           "only; install PIL (Pillow) for JPEG and other formats")
    kw = {"quality": 95} if path.suffix.lower() in (".jpg", ".jpeg") else {}
    pil.fromarray(img).save(path, **kw)


def image_size(path):
    """(height, width) of the image at ``path`` from its header, without
    decoding the pixels; None where it is missing or not an image."""
    path = Path(path)
    if not path.is_file():
        return None
    if _pil() is not None:
        try:
            with _pil().open(path) as im:  # reads the header only
                w, h = im.size
                if im.getexif().get(0x0112, 1) in (5, 6, 7, 8):  # turned by 90 degrees
                    w, h = h, w
                return h, w
        except (OSError, ValueError, EOFError):
            return None
    head = path.read_bytes()[:32]
    if head[:8] == _PNG_SIG:
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    if head[:2] in (b"P5", b"P6"):
        return read_pnm(path).shape[:2]
    raise RuntimeError(f"cannot read the size of {path} without PIL: the built-in reader "
                       "takes PNG and PPM/PGM; install PIL (Pillow) for JPEG and other formats")


# ---------------------------------------------------------------- PNG --


def _chunks(data: bytes):
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def read_png(path) -> np.ndarray:
    """[H, W, C] uint8 of an 8-bit non-interlaced PNG (C: 1 gray, 2
    gray+alpha, 3 RGB or palette, 4 RGBA)."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path} is not a PNG")
    idat, palette, hdr = [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}; the built-in reader takes 8-bit non-interlaced only")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    img = _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, bpp))
    if ctype == 3:
        return palette[img[..., 0]]
    return img


def _unfilter(ftype: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the per-row PNG filters; ``data`` [H, W, bpp] uint8."""
    h, w, bpp = data.shape
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())}")
    if not np.isin(ftype, (3, 4)).any():
        out = np.empty_like(data)
        prior = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            row, f = data[r], ftype[r]
            if f == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint64).astype(np.uint8)
            elif f == 2:
                row = row + prior  # uint8 wraps mod 256
            out[r] = prior = row
        return out
    # anti-diagonal wavefront over a zero-padded frame: out[r + 1, x + 1]
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    d = data.astype(np.int32)
    for t in range(w + 2 * (h - 1)):
        r = np.arange(max(0, (t - w + 2) // 2), min(h, t // 2 + 1))
        x = t - 2 * r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        f = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (d[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def write_png(path, img: np.ndarray, level: int = 6) -> None:
    """An 8-bit PNG of ``img`` (RGB [H, W, 3] or gray [H, W], uint8), every
    row with filter 0."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    Path(path).write_bytes(_PNG_SIG + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                           + chunk(b"IEND", b""))


# ---------------------------------------------------------------- PNM --


def read_pnm(path) -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) with maxval < 256."""
    data = Path(path).read_bytes()
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError(f"{path}: PNM maxval {maxval}; the built-in reader takes 8-bit only")
    c = 3 if data[:2] == b"P6" else 1
    return np.frombuffer(data, np.uint8, h * w * c, pos + 1).reshape(h, w, c)

