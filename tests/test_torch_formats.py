"""The image formats the port reads and writes without cv2 and PIL
(vatl4pose_tpu_torch/data/image_io.py, bmp.py, tiff.py; csrc/jpeg_encode.cpp,
csrc/jpeg_decode.cpp's progressive scans, csrc/image_codecs.cpp), with cv2,
PIL and the JAX package as the oracles:

* the JPEG encoder byte for byte against cv2.imencode over qualities,
  samplings, sizes and gray images, and in a hypothesis test; the
  synthetic generator's jpg and bmp files against the JAX package's
  (cv2.imwrite); the committed JPEG video re-encoded to its bytes;
* the committed fixtures (tests/data/formats/: small BMP, TIFF, PNG and
  progressive JPEG files covering the branches of each reader, a 640x360
  progressive JPEG and a 640x360 LZW TIFF of a video frame) decoded in
  cv2's view (held to the JAX package's decode_frame, cv2.imread) and in
  PIL's view (held to Image.open's mode, pixels and palette), their sizes,
  and convert_to_eps against the JAX package's main (PIL's EPS writer),
  each also against the SHA-256s recorded in expected.json;
* the refusals, each a ValueError naming the file and the field.

The fixtures and expected.json are written again by

    python -m tests.test_torch_formats [dest]

(cv2 and PIL write what they can; the rest is assembled with struct:
RLE4/RLE8, 16-bit bitfields, CORE headers, top-down rows, big-endian,
tiled and associated-alpha TIFFs, sub-byte, 16-bit and interlaced PNGs).
"""

import hashlib
import json
import os
import shutil
import struct
import sys
import tempfile
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tests.test_torch_frames import (FIXTURE, FIXTURE_VIDEO, SAMPLING, SIZES,
                                     sample_image)
from vatl4pose_tpu.cli import convert_to_eps as jax_eps
from vatl4pose_tpu.data import dataset as jax_dataset
from vatl4pose_tpu.data.synthetic import \
    make_synthetic_video as jax_make_synthetic_video
from vatl4pose_tpu_torch.cli import convert_to_eps, prepare_data
from vatl4pose_tpu_torch.data import dataset, image_io
from vatl4pose_tpu_torch.data.synthetic import (IMG_FORMATS,
                                                make_synthetic_video)

REPO = Path(__file__).resolve().parent.parent
FORMATS = REPO / "tests" / "data" / "formats"
QUALITIES = [1, 50, 90, 95, 100]


def sha(b) -> str:
    """SHA-256 of bytes or of an array's elements (a bool array as 0/1:
    PIL's mode "1" arrays hold 255 for True)."""
    if not isinstance(b, bytes):
        b = np.ascontiguousarray(b != 0 if b.dtype == bool else b,
                                 np.uint8 if b.dtype == bool else b.dtype)
        b = b.tobytes()
    return hashlib.sha256(b).hexdigest()


def cv2_jpeg(img, quality, sampling):
    src = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(".jpg", src, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert ok
    return buf.tobytes()


# ---- the encoder ------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("quality", QUALITIES)
def test_encoder_matches_cv2(quality, sampling, size):
    """encode_jpeg writes cv2.imencode's bytes, colour and gray."""
    w, h = size
    img = sample_image(w, h, seed=quality)
    assert image_io.encode_jpeg(img, quality, sampling) \
        == cv2_jpeg(img, quality, sampling)
    gray = np.ascontiguousarray(img[..., 1])
    assert image_io.encode_jpeg(gray, quality, sampling) \
        == cv2_jpeg(gray, quality, sampling)


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 70), h=st.integers(1, 70),
       quality=st.integers(1, 100), sampling=st.sampled_from(
           ["444", "422", "420"]), gray=st.booleans(),
       seed=st.integers(0, 2 ** 31))
def test_encoder_matches_cv2_hypothesis(w, h, quality, sampling, gray, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w) if gray else (h, w, 3), np.uint8)
    if rng.random() < 0.5:                          # smooth: long zero runs
        img = (np.cumsum(img, axis=0) // max(h, 1)).astype(np.uint8)
    assert image_io.encode_jpeg(img, quality, sampling) \
        == cv2_jpeg(img, quality, sampling)


def test_encoder_refusals():
    img = sample_image(9, 7)
    for kw in ({"optimize": True}, {"progressive": True},
               {"restart_interval": 4}):      # baseline, standard tables only
        with pytest.raises(TypeError, match=next(iter(kw))):
            image_io.encode_jpeg(img, **kw)
    for kw, what in (({"sampling": "411"}, "sampling"),
                     ({"quality": 0}, "quality"),
                     ({"quality": 101}, "quality")):
        with pytest.raises(ValueError, match=what):
            image_io.encode_jpeg(img, **kw)
    for bad in (img[..., :2], img.astype(np.float32), np.zeros((0, 4, 3),
                                                               np.uint8)):
        with pytest.raises(ValueError):
            image_io.encode_jpeg(bad)


@pytest.mark.parametrize("img_format", ["jpg", "jpeg", "bmp"])
def test_generator_writes_cv2_bytes(tmp_path, img_format):
    """make_synthetic_video's jpg, jpeg and bmp files equal the JAX
    package's (cv2.imwrite), byte for byte; its npy frames decode from
    the BMP exactly."""
    kw = dict(num_frames=2, num_persons=2, width=45, height=31, seed=5,
              img_format=img_format)
    ours = make_synthetic_video(str(tmp_path / "port"), **kw)
    theirs = jax_make_synthetic_video(str(tmp_path / "jax"), **kw)
    assert ours[1] == theirs[1]
    for f in ("000000", "000001"):
        rel = Path("images") / "000001" / f"{f}.{img_format}"
        assert (tmp_path / "port" / rel).read_bytes() \
            == (tmp_path / "jax" / rel).read_bytes(), rel
    if img_format == "bmp":
        make_synthetic_video(str(tmp_path / "npy"), **dict(kw,
                                                          img_format="npy"))
        want = np.load(tmp_path / "npy" / "images" / "000001" / "000000.npy")
        got = dataset.decode_frame(
            str(tmp_path / "port" / "images" / "000001" / "000000.bmp"))
        assert (got == want).all()


def test_generator_refuses_other_formats(tmp_path):
    assert IMG_FORMATS == ("npy", "png", "jpg", "jpeg", "bmp")
    with pytest.raises(ValueError, match="'webp'.*npy, png, jpg, jpeg, bmp"):
        make_synthetic_video(str(tmp_path), num_frames=1, num_persons=1,
                             width=16, height=16, img_format="webp")
    assert not (tmp_path / "images").exists()


def test_committed_video_reencodes_to_its_bytes(tmp_path):
    """The generator's 16 frames at FIXTURE_VIDEO, written by write_jpeg
    at quality 90 and 4:2:0, are the committed files byte for byte."""
    root, ann = make_synthetic_video(str(tmp_path), **FIXTURE_VIDEO)
    with open(os.path.join(root, ann)) as f:
        images = json.load(f)["images"]
    assert len(images) == 16
    for im in images:
        rgb = np.load(os.path.join(root, im["file_name"]))
        jpg = FIXTURE / im["file_name"].replace(".npy", ".jpg")
        assert image_io.encode_jpeg(rgb, 90, "420") == jpg.read_bytes(), jpg


# ---- assembling what neither library writes ----------------------------------

def bmp_file(width, height, bits, rows, compression=0, header=40,
             palette=None, masks=None, colors=0, topdown=False, data=None):
    """A BMP: `rows` the stored rows (file order, unpadded), or `data` the
    pixel bytes as they are (RLE); `palette` (n, 3) RGB; `masks` (R, G,
    B[, A]) inside a header of 52 bytes or more, after a 40-byte one."""
    if data is None:
        stride = (width * bits + 31) // 32 * 4
        data = b"".join(r + bytes(stride - len(r)) for r in rows)
    pal = b""
    if palette is not None:
        pad = b"" if header == 12 else b"\0"
        pal = b"".join(bytes([b, g, r]) + pad for r, g, b in palette)
    after = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width,
                           -height if topdown else height, 1, bits,
                           compression, len(data), 2835, 2835, colors, 0)
        if header > 40:
            m = list(masks or ()) + [0] * 4
            info += struct.pack("<IIII", *m[:4])
            info = info[:header] + bytes(max(0, header - len(info)))
        elif masks is not None:
            after = struct.pack(f"<{len(masks)}I", *masks)
    off = 14 + len(info) + len(after) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info
            + after + pal + data)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more as repeats, the rest as literals."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_file(px, photometric, order="<", bits=8, compression=1,
              predictor=1, rows_per_strip=None, tile=None, extra=None,
              colormap=None, extra_tags=()):
    """A TIFF of the (H, W, spp) uint8 samples `px` ((H, W) 0/1 at 1 bit),
    strips or (tw, tl) tiles, the IFD after the data."""
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else px.shape[2]

    def pack(block):          # (rows, cols[, spp]) -> bytes
        if bits == 1:
            return np.packbits(block.astype(np.uint8), axis=1).tobytes()
        if predictor == 2:
            block = block.astype(np.int16)
            block = np.concatenate([block[:, :1], np.diff(block, axis=1)],
                                   1).astype(np.uint8)
        return np.ascontiguousarray(block).tobytes()

    def compress(raw):
        return {1: raw, 8: zlib.compress(raw), 32946: zlib.compress(raw),
                32773: packbits(raw)}[compression]

    chunks = []
    if tile:
        tw, tl = tile
        padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw)
                          + px.shape[2:], px.dtype)
        padded[:h, :w] = px
        for r in range(0, padded.shape[0], tl):
            for c in range(0, padded.shape[1], tw):
                chunks.append(compress(pack(padded[r:r + tl, c:c + tw])))
    else:
        rps = rows_per_strip or h
        for r in range(0, h, rps):
            chunks.append(compress(pack(px[r:r + rps])))
    body = bytearray(8)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
        if len(body) % 2:
            body += b"\0"
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
            (259, 3, [compression]), (262, 3, [photometric]),
            (277, 3, [spp])]
    if tile:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]),
                 (324, 4, offsets), (325, 4, [len(c) for c in chunks])]
    else:
        tags += [(273, 4, offsets), (278, 4, [rows_per_strip or h]),
                 (279, 4, [len(c) for c in chunks])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if colormap is not None:
        tags.append((320, 3, list(colormap)))
    if extra is not None:
        tags.append((338, 3, list(extra)))
    tags += list(extra_tags)
    tags.sort()
    fmt = {3: "H", 4: "I"}
    entries, values = [], bytearray()
    ifd_size = 2 + 12 * len(tags) + 4
    ifd_at = len(body)
    out_at = ifd_at + ifd_size
    for tag, typ, vals in tags:
        raw = struct.pack(f"{order}{len(vals)}{fmt[typ]}", *vals)
        if len(raw) <= 4:
            field = raw + bytes(4 - len(raw))
        else:
            field = struct.pack(order + "I", out_at + len(values))
            values += raw + (b"\0" if len(raw) % 2 else b"")
        entries.append(struct.pack(order + "HHI", tag, typ, len(vals))
                       + field)
    magic = b"II*\0" if order == "<" else b"MM\0*"
    body[:8] = magic + struct.pack(order + "I", ifd_at)
    return bytes(body + struct.pack(order + "H", len(tags))
                 + b"".join(entries) + b"\0\0\0\0" + values)


def png_file(px, depth, ctype, palette=None, trns=None, interlace=False):
    """A PNG of the (H, W, channels) samples `px` (uint16 at 16 bits,
    integer values at 1-4 bits), every filter type in turn row by row,
    Adam7 if `interlace`."""
    h, w, ch = px.shape
    bpp = max(1, ch * depth // 8)

    def rows_of(img):
        hh, ww = img.shape[:2]
        if depth == 16:
            raw = img.astype(">u2").reshape(hh, ww * ch).view(np.uint8)
        elif depth == 8:
            raw = img.reshape(hh, ww * ch).astype(np.uint8)
        else:
            bits = ((img.reshape(hh, ww, 1) >> np.arange(depth - 1, -1, -1))
                    & 1).astype(np.uint8)
            raw = np.packbits(bits.reshape(hh, ww * depth), axis=1)
        out, prior = bytearray(), np.zeros(raw.shape[1], np.int32)
        for y in range(hh):
            cur = raw[y].astype(np.int32)
            ftype = y % 5
            left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
            up_left = np.concatenate([np.zeros(bpp, np.int32),
                                      prior[:-bpp]])
            if ftype == 0:
                pred = np.zeros_like(cur)
            elif ftype == 1:
                pred = left
            elif ftype == 2:
                pred = prior
            elif ftype == 3:
                pred = (left + prior) >> 1
            else:
                p = left + prior - up_left
                pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                              np.abs(p - up_left))
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prior, up_left))
            out += bytes([ftype]) + ((cur - pred) & 255).astype(
                np.uint8).tobytes()
            prior = cur
        return bytes(out)

    if interlace:
        raw = b"".join(rows_of(px[y0::dy, x0::dx])
                       for x0, y0, dx, dy in image_io._ADAM7
                       if w > x0 and h > y0)
    else:
        raw = rows_of(px)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def old_style_lzw():
    """A TIFF whose strip starts as old-style (LSB-first) LZW does: its
    raw samples declared LZW, the first two bytes 0x00 0x01."""
    px = sample_image(8, 8)
    px[0, 0, :2] = (0, 1)
    data = tiff_file(px, 2)
    entry = struct.pack("<HHIH", 259, 3, 1, 1)
    return data.replace(entry, struct.pack("<HHIH", 259, 3, 1, 5))


def pil_bytes(im, fmt, **kw):
    import io
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def cv2_bytes(ext, img, params=()):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


def fixture_files():
    """{file name: bytes} of every fixture, made from fixed seeds."""
    rng = np.random.default_rng(15)
    img = sample_image(23, 11, seed=15)                  # (11, 23, 3) RGB
    W, H = 23, 11
    files = {}
    # -- BMP
    files["bmp_24_cv2.bmp"] = cv2_bytes(".bmp", img[..., ::-1])
    files["bmp_gray8_cv2.bmp"] = cv2_bytes(".bmp", img[..., 0].copy())
    files["bmp_1bit_pil.bmp"] = pil_bytes(
        Image.fromarray(img[..., 0] > 100), "BMP")
    files["bmp_pal8_pil.bmp"] = pil_bytes(
        Image.fromarray(img).convert("P"), "BMP")
    pal16 = rng.integers(0, 256, (16, 3), np.uint8)
    idx4 = rng.integers(0, 16, (H, W), np.uint8)
    rows4 = [np.packbits(((r[:, None] >> np.arange(3, -1, -1)) & 1)
                         .astype(np.uint8).ravel()).tobytes()
             for r in idx4[::-1]]
    files["bmp_pal4.bmp"] = bmp_file(W, H, 4, rows4, palette=pal16)
    pal2 = np.array([[200, 30, 40], [10, 220, 90]], np.uint8)
    idx1 = (img[..., 1] > 120).astype(np.uint8)
    files["bmp_pal1_topdown.bmp"] = bmp_file(
        W, H, 1, [np.packbits(r).tobytes() for r in idx1], palette=pal2,
        topdown=True)
    pal6 = rng.integers(0, 256, (6, 3), np.uint8)        # biClrUsed 6
    idx8 = rng.integers(0, 8, (H, W), np.uint8)          # 6, 7 past it
    files["bmp_pal8_short.bmp"] = bmp_file(
        W, H, 8, [r.tobytes() for r in idx8[::-1]], palette=pal6, colors=6)
    files["bmp_core_pal8.bmp"] = bmp_file(
        W, H, 8, [r.tobytes() for r in idx8[::-1]], header=12,
        palette=np.concatenate([pal6, rng.integers(0, 256, (250, 3),
                                                   np.uint8)]))
    files["bmp_core_24.bmp"] = bmp_file(
        W, H, 24, [r[:, ::-1].tobytes() for r in img[::-1]], header=12)
    files["bmp_v3_24_topdown.bmp"] = bmp_file(
        W, H, 24, [r[:, ::-1].tobytes() for r in img], header=56,
        topdown=True)
    words = rng.integers(0, 1 << 16, (H, W)).astype("<u2")
    files["bmp_16_555.bmp"] = bmp_file(
        W, H, 16, [r.tobytes() for r in words & 0x7FFF])
    files["bmp_16_565.bmp"] = bmp_file(
        W, H, 16, [r.tobytes() for r in words], compression=3,
        masks=(0xF800, 0x7E0, 0x1F))
    files["bmp_16_565_v5.bmp"] = bmp_file(
        W, H, 16, [r.tobytes() for r in words], compression=3, header=124,
        masks=(0xF800, 0x7E0, 0x1F, 0))
    px32 = rng.integers(0, 256, (H, W, 4), np.uint8)
    files["bmp_32.bmp"] = bmp_file(W, H, 32, [r.tobytes() for r in px32])
    files["bmp_32_v5_bgra.bmp"] = bmp_file(
        W, H, 32, [r.tobytes() for r in px32], compression=3, header=124,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    files["bmp_32_v4_rgba.bmp"] = bmp_file(
        W, H, 32, [r.tobytes() for r in px32], compression=3, header=108,
        masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    files["bmp_32_v2_xbgr.bmp"] = bmp_file(
        W, H, 32, [r.tobytes() for r in px32], compression=3, header=52,
        masks=(0xFF000000, 0xFF0000, 0xFF00))
    pal256 = rng.integers(0, 256, (256, 3), np.uint8)
    # RLE8: encoded runs, absolute runs (odd length padded), a row ended
    # early by end of line (the rest index 0), the last row by end of
    # bitmap
    rle8 = bytearray()
    for y in range(H):
        if y == 2:
            rle8 += bytes([5, 7, 0, 0])              # 5 pixels, then EOL
            continue
        rle8 += bytes([4, y]) + bytes([0, 7]) + bytes(range(10, 17)) \
            + b"\0" + bytes([12, 200 + y])
        rle8 += bytes([0, 0]) if y < H - 1 else bytes([0, 1])
    files["bmp_rle8.bmp"] = bmp_file(W, H, 8, None, compression=1,
                                     palette=pal256, data=bytes(rle8))
    # RLE4: odd encoded runs, an absolute run of an odd byte count
    rle4 = bytearray()
    for y in range(H):
        rle4 += bytes([5, 0x3C]) + bytes([0, 6, 0x12, 0x34, 0x56, 0])
        rle4 += bytes([12, 0xF0 + y % 16])
        rle4 += bytes([0, 0]) if y < H - 1 else bytes([0, 1])
    files["bmp_rle4.bmp"] = bmp_file(W, H, 4, None, compression=2,
                                     palette=pal16, data=bytes(rle4))
    # -- TIFF
    pil_rgb = Image.fromarray(img)
    for comp in ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"):
        files[f"tif_rgb_{comp.split('_')[-1]}.tif"] = pil_bytes(
            pil_rgb, "TIFF", compression=comp)
    files["tif_rgb_lzw_pred_cv2.tif"] = cv2_bytes(".tif", img[..., ::-1])
    rgba = np.concatenate([img, rng.integers(0, 256, (H, W, 1),
                                             np.uint8)], -1)
    rgba[0, :4, 3] = (0, 255, 1, 128)
    files["tif_rgba_pil.tif"] = pil_bytes(
        Image.fromarray(rgba, "RGBA"), "TIFF", compression="tiff_lzw")
    files["tif_rgba_cv2.tif"] = cv2_bytes(".tif", rgba[..., [2, 1, 0, 3]])
    premul = rgba.copy()
    premul[..., :3] = (rgba[..., :3].astype(int) * rgba[..., 3:] // 255)
    files["tif_rgba_assoc.tif"] = tiff_file(premul, 2, extra=(1,))
    files["tif_la_pil.tif"] = pil_bytes(
        Image.fromarray(rgba[..., [0, 3]], "LA"), "TIFF",
        compression="packbits")
    files["tif_l_pil.tif"] = pil_bytes(Image.fromarray(img[..., 1]), "TIFF",
                                       compression="tiff_adobe_deflate")
    files["tif_l_whiteiszero.tif"] = tiff_file(img[..., 1:2], 0,
                                               rows_per_strip=4)
    files["tif_1bit_pil.tif"] = pil_bytes(
        Image.fromarray(img[..., 0] > 100), "TIFF")
    files["tif_1bit_whiteiszero.tif"] = tiff_file(
        (img[..., 0] > 100).astype(np.uint8), 0, bits=1, compression=32773)
    files["tif_p_pil.tif"] = pil_bytes(Image.fromarray(img).convert("P"),
                                       "TIFF", compression="tiff_lzw")
    cmap8 = rng.integers(0, 256, 3 * 256)                # all below 256
    files["tif_p_cmap8.tif"] = tiff_file(idx8[..., None] * 30, 3,
                                         colormap=cmap8)
    files["tif_cmyk_pil.tif"] = pil_bytes(
        Image.fromarray(px32, "CMYK"), "TIFF", compression="tiff_lzw")
    big = sample_image(37, 21, seed=3)
    files["tif_rgb_bigendian.tif"] = tiff_file(big, 2, order=">",
                                               rows_per_strip=5,
                                               compression=32773)
    files["tif_p_bigendian.tif"] = tiff_file(
        idx8[..., None], 3, order=">",
        colormap=rng.integers(0, 1 << 16, 3 * 256))
    files["tif_rgb_tiled.tif"] = tiff_file(big, 2, tile=(16, 16),
                                           compression=8, predictor=2)
    files["tif_l_tiled_bigendian.tif"] = tiff_file(
        big[..., :1], 1, order=">", tile=(16, 32))
    files["tif_rgb_jpeg.tif"] = pil_bytes(pil_rgb, "TIFF", compression="jpeg")
    files["tif_l16.tif"] = pil_bytes(
        Image.fromarray(words.astype(np.uint16)), "TIFF")
    files["tif_rgb_planar2.tif"] = tiff_file(img, 2, extra_tags=[
        (284, 3, [2])])
    # -- PNG
    files["png_pal8_trns.png"] = pil_bytes(
        Image.fromarray(img).convert("P"), "PNG",
        transparency=bytes(range(0, 250, 10)))
    for bits in (1, 2, 4):
        n = 1 << bits
        pil = Image.fromarray(rng.integers(0, n, (H, W), np.uint8), "P")
        pil.putpalette(rng.integers(0, 256, 3 * n, np.uint8).tolist())
        files[f"png_pal{bits}.png"] = pil_bytes(pil, "PNG", bits=bits)
    for bits in (1, 2, 4):
        files[f"png_gray{bits}.png"] = png_file(
            rng.integers(0, 1 << bits, (H, W, 1), np.uint8), bits, 0)
    files["png_gray8_trns.png"] = png_file(img[..., :1], 8, 0,
                                           trns=b"\0\x40")
    w16 = rng.integers(0, 1 << 16, (H, W, 4)).astype(np.uint16)
    files["png_gray16.png"] = png_file(w16[..., :1], 16, 0)
    files["png_la16.png"] = png_file(w16[..., :2], 16, 4)
    files["png_rgb16.png"] = png_file(w16[..., :3], 16, 2)
    files["png_rgba16.png"] = png_file(w16, 16, 6)
    files["png_rgb8_trns.png"] = png_file(img, 8, 2, trns=b"\0\x10\0\x20"
                                          b"\0\x30")
    files["png_rgba_adam7.png"] = png_file(rgba, 8, 6, interlace=True)
    files["png_gray2_adam7.png"] = png_file(
        rng.integers(0, 4, (H, W, 1), np.uint8), 2, 0, interlace=True)
    files["png_pal4_adam7.png"] = png_file(
        idx4[..., None], 4, 3, palette=pal16, interlace=True)
    files["png_rgb16_adam7_tiny.png"] = png_file(w16[:3, :2, :3], 16, 2,
                                                 interlace=True)
    files["png_colortype5.png"] = png_file(img[..., :1], 8, 0)[:25] + b"\5" \
        + png_file(img[..., :1], 8, 0)[26:]
    # -- progressive JPEG
    prog = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    files["jpg_prog_420.jpg"] = cv2_bytes(".jpg", img[..., ::-1], prog)
    files["jpg_prog_444_q100.jpg"] = cv2_bytes(
        ".jpg", img[..., ::-1], prog + [
            cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            SAMPLING["444"]])
    files["jpg_prog_422_rst.jpg"] = cv2_bytes(
        ".jpg", big[..., ::-1], prog + [
            cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["422"]])
    files["jpg_prog_gray.jpg"] = cv2_bytes(".jpg", big[..., 1].copy(), prog)
    files["jpg_prog_pil.jpg"] = pil_bytes(pil_rgb, "JPEG", progressive=True,
                                          quality=80)
    # -- a video frame at 640x360, for timing
    frame = jax_dataset.decode_frame(str(FIXTURE / "images" / "000001"
                                         / "000000.jpg"))
    files["frame_640x360_prog.jpg"] = cv2_bytes(
        ".jpg", frame[..., ::-1], prog + [cv2.IMWRITE_JPEG_QUALITY, 90])
    files["frame_640x360_lzw.tif"] = pil_bytes(
        Image.fromarray(frame), "TIFF", compression="tiff_lzw")
    return files


# what the port refuses of the fixtures, in both views: a fragment of the
# ValueError's message (the file's name is in it too)
REFUSED = {"tif_rgb_jpeg.tif": "TIFF Compression=7",
           "tif_l16.tif": "TIFF BitsPerSample=16",
           "tif_rgb_planar2.tif": "TIFF PlanarConfiguration=2",
           "png_colortype5.png": "PNG colour type 5"}
# of cv2's view only (OpenCV returns None for it too)
REFUSED_CV2 = {"bmp_16_565_v5.bmp": "BI_BITFIELDS masks"}
TIMED = ("frame_640x360_prog.jpg", "frame_640x360_lzw.tif")
LIBTIFF_LZW = ("frame_640x360_lzw.tif",)


def oracle_cv2(path):
    """cv2's view through the JAX package's decode_frame: the RGB's
    SHA-256 and shape, or None where cv2 cannot read the file."""
    if cv2.imread(str(path)) is None:
        return None
    rgb = jax_dataset.decode_frame(str(path))
    return {"sha256": sha(rgb), "shape": list(rgb.shape)}


def oracle_pil(path):
    try:
        im = Image.open(path)
        px = np.asarray(im)
    except Exception:                              # noqa: BLE001
        return None
    out = {"mode": im.mode, "shape": list(px.shape), "dtype": str(px.dtype),
           "sha256": sha(px)}
    if im.mode == "P":
        out["palette_sha256"] = sha(bytes(im.getpalette()))
        out["rgb_sha256"] = sha(np.asarray(im.convert("RGB")))
    return out


def oracle_eps(path):
    """The JAX package's convert_to_eps main on the file alone: the EPS's
    SHA-256, or the ValueError's message."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(path, tmp)
        try:
            (out,) = jax_eps.main(["--dir", tmp])
        except Exception as e:                     # noqa: BLE001
            return {"error": f"{type(e).__name__}: "
                             f"{str(e).replace(tmp, '<dir>')}"}
        return {"sha256": sha(Path(out).read_bytes())}


def expected_entry(path):
    name = Path(path).name
    cv = cv2.imread(str(path))
    entry = {"cv2": oracle_cv2(path), "pil": oracle_pil(path),
             "eps": oracle_eps(path),
             "size": None if cv is None else [cv.shape[1], cv.shape[0]]}
    if name in REFUSED:
        entry["refused"] = REFUSED[name]
    if name in REFUSED_CV2:
        entry["refused_cv2"] = REFUSED_CV2[name]
    return entry


def write_fixtures(dest=FORMATS):
    """Writes the fixtures and expected.json anew (see the module's
    docstring)."""
    dest = Path(dest)
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    files = fixture_files()
    for name, data in files.items():
        (dest / name).write_bytes(data)
    expected = {name: expected_entry(dest / name) for name in sorted(files)}
    with open(dest / "expected.json", "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    return expected


with open(FORMATS / "expected.json") as _f:
    EXPECTED = json.load(_f)
NAMES = sorted(EXPECTED)


def test_fixtures_are_the_generators():
    """The committed fixtures are fixture_files()'s bytes, and within the
    size budget; expected.json lists each one."""
    files = fixture_files()
    assert sorted(files) == NAMES
    for name, data in files.items():
        if name in LIBTIFF_LZW:
            # libtiff's LZW encoder leaves bits past its last code as they
            # were in memory: the same length and decode
            committed = FORMATS / name
            assert committed.stat().st_size == len(data)
            assert (cv2.imdecode(np.frombuffer(data, np.uint8),
                                 cv2.IMREAD_COLOR)
                    == cv2.imread(str(committed))).all()
            continue
        assert (FORMATS / name).read_bytes() == data, name
    total = sum(p.stat().st_size for p in FORMATS.iterdir())
    assert total < 1 << 20, total


@pytest.mark.parametrize("name", NAMES)
def test_cv2_view(name):
    """read_images equals cv2 (the JAX package's decode_frame) on the
    file, and the recorded hash; image_size equals cv2's sides."""
    path = str(FORMATS / name)
    entry = EXPECTED[name]
    assert oracle_cv2(path) == entry["cv2"]
    refusal = entry.get("refused") or entry.get("refused_cv2")
    if refusal:
        with pytest.raises(ValueError, match=f"{name}.*{refusal}"):
            dataset.decode_frame(path)
        return
    got = dataset.decode_frame(path)
    want = jax_dataset.decode_frame(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want)
    assert not diff.any(), (diff.max(), np.argwhere(diff)[:5].tolist())
    assert sha(got) == entry["cv2"]["sha256"]
    assert list(image_io.image_size(path)) == entry["size"]
    assert prepare_data._img_size(path) == tuple(entry["size"])


@pytest.mark.parametrize("name", NAMES)
def test_pil_view(name):
    """read_image_mode equals Image.open's mode, pixels and palette (and
    the recorded hashes)."""
    path = str(FORMATS / name)
    entry = EXPECTED[name]
    assert oracle_pil(path) == entry["pil"]
    if "refused" in entry:
        with pytest.raises(ValueError, match=f"{name}.*{entry['refused']}"):
            image_io.read_image_mode(path)
        return
    mode, px, palette = image_io.read_image_mode(path)
    im = Image.open(path)
    want = np.asarray(im)
    assert mode == im.mode == entry["pil"]["mode"]
    assert px.dtype == want.dtype and px.shape == want.shape
    assert (px == want).all()
    assert sha(px) == entry["pil"]["sha256"]
    if mode == "P":
        assert bytes(palette.ravel()) == bytes(im.getpalette())
        assert sha(image_io.palette_to_rgb(px, palette)) \
            == entry["pil"]["rgb_sha256"]
    else:
        assert palette is None


@pytest.mark.parametrize("name", NAMES)
def test_convert_to_eps_matches_jax(name, tmp_path):
    """convert_to_eps.main on the file alone writes the JAX main's EPS
    bytes, or raises as it raises (a mode PIL's EPS writer refuses)."""
    entry = EXPECTED[name]
    assert oracle_eps(FORMATS / name) == entry["eps"]
    shutil.copy(FORMATS / name, tmp_path)
    if "refused" in entry:
        with pytest.raises(ValueError, match=entry["refused"]):
            convert_to_eps.main(["--dir", str(tmp_path)])
        return
    if "error" in entry["eps"]:
        assert entry["eps"]["error"].startswith("ValueError: ")
        with pytest.raises(ValueError,
                           match=entry["eps"]["error"][len("ValueError: "):]):
            convert_to_eps.main(["--dir", str(tmp_path)])
        assert os.listdir(tmp_path) == [name]
        return
    (out,) = convert_to_eps.main(["--dir", str(tmp_path)])
    assert sha(Path(out).read_bytes()) == entry["eps"]["sha256"]


def test_fixture_coverage():
    """The fixtures cover each reader's branches: every BMP header, the
    PIL modes of every format, CMYK and mode "1" at the EPS writer, and
    the two frames chip_smoke.py times."""
    modes = {EXPECTED[n]["pil"]["mode"] for n in NAMES
             if EXPECTED[n]["pil"] and "refused" not in EXPECTED[n]}
    assert {"1", "L", "LA", "P", "RGB", "RGBA", "CMYK", "I;16"} <= modes
    eps_errors = [n for n in NAMES if "error" in EXPECTED[n]["eps"]]
    assert any(EXPECTED[n]["pil"]["mode"] == "1" for n in eps_errors)
    assert any(EXPECTED[n]["pil"]["mode"] == "CMYK" and
               "sha256" in EXPECTED[n]["eps"] for n in NAMES
               if EXPECTED[n]["pil"])
    headers = {struct.unpack_from("<I", (FORMATS / n).read_bytes(), 14)[0]
               for n in NAMES if n.endswith(".bmp")}
    assert {12, 40, 52, 56, 108, 124} <= headers
    for name in TIMED:                      # chip_smoke.py times these
        assert EXPECTED[name]["size"] == [640, 360]


def test_refusals_name_the_file_and_the_field(tmp_path):
    """Every refusal is a ValueError naming the file and the field: the
    fixtures the port refuses, and broken files of each kind."""
    for name, field in {**REFUSED, **REFUSED_CV2}.items():
        with pytest.raises(ValueError, match=f"{name}.*{field}"):
            image_io.read_images([str(FORMATS / name)])
    base = (FORMATS / "tif_rgb_raw.tif").read_bytes()
    cases = {
        "gif.bmp": (b"GIF89a" + bytes(30), "not a JPEG, PNG, BMP or TIFF"),
        "hdr.bmp": (bmp_file(4, 4, 24, [bytes(12)] * 4)[:14]
                    + struct.pack("<I", 20) + bytes(40),
                    "BMP header size 20"),
        "comp.bmp": (bmp_file(4, 4, 24, [bytes(12)] * 4, compression=4),
                     "BMP compression 4"),
        "cut.bmp": (bmp_file(4, 4, 24, [bytes(12)] * 4)[:-10],
                    "truncated BMP pixel data"),
        "rle.bmp": (bmp_file(4, 2, 8, None, compression=1,
                             palette=np.zeros((256, 3), np.uint8),
                             data=bytes([9, 1, 0, 1])),
                    "RLE8.*past the end of row 0"),
        "ifd.tif": (base[:4] + struct.pack("<I", 1 << 30) + base[8:],
                    "IFD offset"),
        "ycc.tif": (tiff_file(sample_image(8, 8), 6), "Photometric"),
        "fill.tif": (tiff_file(sample_image(8, 8), 2,
                               extra_tags=[(266, 3, [2])]), "FillOrder=2"),
        "orient.tif": (tiff_file(sample_image(8, 8), 2,
                                 extra_tags=[(274, 3, [6])]),
                       "Orientation=6"),
        "extra.tif": (tiff_file(sample_image(8, 8)[..., :2], 1,
                                extra=(1,)), "ExtraSamples=1"),
        "pred.tif": (tiff_file(sample_image(8, 8), 2,
                               extra_tags=[(317, 3, [3])]), "Predictor=3"),
        "lzw.tif": (old_style_lzw(), "Compression=5.*old-style"),
        "arith.jpg": (None, "arithmetic"),
        "depth.png": (png_file(sample_image(4, 4)[..., :1], 8, 0)[:24]
                      + b"\3" + png_file(sample_image(4, 4)[..., :1], 8,
                                         0)[25:], "3-bit PNG"),
    }
    jpg = cv2_bytes(".jpg", sample_image(16, 16))
    sof = jpg.index(b"\xff\xc0")
    cases["arith.jpg"] = (jpg[:sof + 1] + b"\xc9" + jpg[sof + 2:],
                          "arithmetic.*0xFFC9")
    for name, (data, field) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=f"{name}.*{field}"):
            image_io.read_images([str(path)])
        with pytest.raises(ValueError, match=name):
            image_io.read_image_mode(str(path))


def jpeg_scans(data):
    """The (start, end) byte ranges of a JPEG's scans, each from the
    Huffman tables just before its SOS to the end of its entropy-coded
    data, and the offset of the EOI marker."""
    pos, start, scans = 2, 2, []
    while True:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        if marker == 0xD9:
            return scans, pos
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker != 0xDA:
            if marker != 0xC4:
                start = pos
            continue
        while not (data[pos] == 0xFF and data[pos + 1] != 0
                   and not 0xD0 <= data[pos + 1] <= 0xD7):
            pos += 1
        scans.append((start, pos))
        start = pos


@pytest.mark.parametrize("cut", ["first", "mid", "last", "drop_dc",
                                 "drop_ac"])
def test_progressive_scan_script_is_checked(tmp_path, cut):
    """A progressive JPEG whose scans stop early (cut off and closed with
    EOI), or whose script skips the DC first scan or an AC first scan, is
    refused by name: libjpeg-turbo would decode it with its block
    smoothing, or with a bogus progression warning."""
    data = cv2_bytes(".jpg", sample_image(24, 16),
                     [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    scans, eoi = jpeg_scans(data)
    assert len(scans) == 10                 # libjpeg's default script
    header = data[:scans[0][0]]
    keep = {"first": scans[:1], "mid": scans[:5], "last": scans[:-1],
            "drop_dc": scans[1:], "drop_ac": scans[:1] + scans[2:]}[cut]
    body = b"".join(data[a:b] for a, b in keep)
    path = tmp_path / f"{cut}.jpg"
    path.write_bytes(header + body + data[eoi:])
    field = {"first": "incomplete progressive", "mid": "incomplete "
             "progressive", "last": "incomplete progressive.*low 1 bits",
             "drop_dc": "AC scan of component 1 before its first DC",
             "drop_ac": "bad progression: component 1 coefficient 1 "
             "scanned with Ah 2 where 0"}[cut]
    with pytest.raises(ValueError, match=f"{cut}\\.jpg.*{field}"):
        image_io.read_images([str(path)])
    whole = tmp_path / "whole.jpg"
    whole.write_bytes(header + b"".join(data[a:b] for a, b in scans)
                      + data[eoi:])
    assert whole.read_bytes() == data
    np.testing.assert_array_equal(image_io.read_images([str(whole)])[0],
                                  jax_dataset.decode_frame(str(whole)))


def test_codecs_build_key_and_lzw_old_style(tmp_path):
    """The codecs' and the encoder's libraries are keyed as the decoder's
    (source, flags, g++ --version); old-style LZW strips are refused by
    name."""
    from vatl4pose_tpu_torch.data import image_codecs, native_warp
    for source, stem in ((image_codecs.SOURCE, "image_codecs"),
                         (image_io.ENCODER_SOURCE, "jpeg_encode")):
        path = native_warp.host_library_path(source, stem)
        assert path.parent == native_warp.BUILD_DIR
        assert path.name.startswith(f"lib{stem}-")
    with pytest.raises(ValueError, match="old-style"):
        image_codecs.tiff_decompress(5, b"\0\1\2\3", 4, "x.tif")


if __name__ == "__main__":
    write_fixtures(sys.argv[1] if len(sys.argv) > 1 else FORMATS)
