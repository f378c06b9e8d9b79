"""Frame decoding without cv2 (vatl4pose_tpu_torch/data/image_io.py, the
JPEG decoder in csrc/jpeg_decode.cpp) against the JAX package's
decode_frame, which is cv2.imread + BGR->RGB: bit-identical on JPEGs that
cv2 writes here over a matrix of samplings, qualities, sizes, restart
intervals, optimized Huffman tables, grayscale and EXIF orientations; PNG
gray, RGB and RGBA under every filter; header sizes; the refusals; the
resident dataset and the FrameStore over JPEG and PNG frames; and the
committed JPEG video.

The committed video (tests/data/jpeg_video/: 16 frames of the seeded
synthetic video at 640x360 with 8 persons, 128 samples, written by
cv2.imwrite at quality 90 with 4:2:0 sampling, its annotation and the
SHA-256 of cv2's RGB decode of each frame) is written again by

    python -m tests.test_torch_frames
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

from vatl4pose_tpu.data import dataset as jax_dataset
from vatl4pose_tpu_torch.cli import prepare_data
from vatl4pose_tpu_torch.data import build_dataset, dataset, image_io
from vatl4pose_tpu_torch.data import native_warp
from vatl4pose_tpu_torch.data.stream import FrameStore
from vatl4pose_tpu_torch.data.synthetic import make_synthetic_video

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "jpeg_video"
FIXTURE_VIDEO = dict(num_frames=16, num_persons=8, width=640, height=360,
                     seed=0)
FIXTURE_ANN = "annotations/000001.json"
FIXTURE_JPEG = [cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(1, 1), (8, 8), (17, 13), (641, 361), (3760, 32)]     # (w, h)
PNG_FILTERS = {"none": (cv2.IMWRITE_PNG_FILTER_NONE, {0}),
               "sub": (cv2.IMWRITE_PNG_FILTER_SUB, {1}),
               "up": (cv2.IMWRITE_PNG_FILTER_UP, {2}),
               "avg": (cv2.IMWRITE_PNG_FILTER_AVG, {3}),
               "paeth": (cv2.IMWRITE_PNG_FILTER_PAETH, {4}),
               "all": (cv2.IMWRITE_PNG_ALL_FILTERS, None)}


def rgb_sha256(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def sample_image(w, h, seed=0):
    """Gradients, noise, saturated black and white and pure colours: the
    IDCT's clamps, chroma edges and busy blocks in one (H, W, 3) uint8
    RGB image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7 + yy * 3) % 256, (yy * 11) % 256,
                    (xx * yy) % 256], -1).astype(np.float64)
    img += rng.normal(0, 25, (h, w, 3))
    img[: h // 3, : w // 4] = 0
    img[h // 3: h // 2, w // 4: w // 2] = 255
    img[h // 2:, : w // 5] = (255, 0, 0)
    img[h // 2:, w // 5: 2 * w // 5] = (0, 0, 255)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_jpeg(path, rgb, params):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
                           if rgb.ndim == 3 else rgb, params)
    assert ok
    Path(path).write_bytes(buf.tobytes())


def assert_decodes_as_jax(path):
    """The port's decode_frame equals the JAX package's (cv2) bit for
    bit, and image_size equals the decode's sides."""
    want = jax_dataset.decode_frame(str(path))
    got = dataset.decode_frame(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want)
    assert not diff.any(), (diff.max(), np.argwhere(diff)[:5].tolist())
    assert image_io.image_size(str(path)) == (want.shape[1], want.shape[0])


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_jpeg_matrix_matches_cv2(tmp_path, sampling, quality, size):
    w, h = size
    path = tmp_path / "f.jpg"
    write_jpeg(path, sample_image(w, h, seed=quality), [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert_decodes_as_jax(path)


@pytest.mark.parametrize("sampling", ["440", "411"])
def test_jpeg_other_samplings_match_cv2(tmp_path, sampling):
    """4:4:0 (h1v2 fancy upsampling) and 4:1:1 (replication) at odd
    sides."""
    for w, h in ((641, 361), (37, 5), (3, 2)):
        path = tmp_path / "f.jpg"
        write_jpeg(path, sample_image(w, h), [
            cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
        assert_decodes_as_jax(path)


def restart_markers(path):
    data = Path(path).read_bytes()
    return sum(data.count(bytes([0xFF, 0xD0 + n])) for n in range(8))


@pytest.mark.parametrize("interval", [1, 3, 7])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_jpeg_restart_intervals_match_cv2(tmp_path, sampling, interval):
    """Restart markers mid-row (641 px: 41 MCUs of 4:2:0 a row) at quality
    100, where FF bytes, stuffed as FF 00, sit next to the markers."""
    path = tmp_path / "f.jpg"
    write_jpeg(path, sample_image(641, 361, seed=interval), [
        cv2.IMWRITE_JPEG_QUALITY, 100,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    assert restart_markers(path) > 40
    assert_decodes_as_jax(path)


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_jpeg_optimized_huffman_matches_cv2(tmp_path, sampling):
    path = tmp_path / "f.jpg"
    write_jpeg(path, sample_image(641, 361, seed=5), [
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    assert_decodes_as_jax(path)


@pytest.mark.parametrize("size", [(1, 1), (17, 13), (641, 361)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_grayscale_matches_cv2(tmp_path, size):
    """One component, replicated into three channels."""
    path = tmp_path / "g.jpg"
    write_jpeg(path, sample_image(*size)[..., 1], [cv2.IMWRITE_JPEG_QUALITY,
                                                 90])
    assert_decodes_as_jax(path)
    got = dataset.decode_frame(str(path))
    assert (got[..., 0] == got[..., 1]).all() and (
        got[..., 0] == got[..., 2]).all()


def exif_app1(orientation, little_endian):
    """An APP1 Exif segment whose IFD0 holds the orientation tag."""
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 2)
            + struct.pack(e + "HHII", 0x010F, 2, 4, 0x00657A)    # Make
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("little_endian", [True, False], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_matches_cv2(tmp_path, orientation,
                                           little_endian):
    """EXIF orientations 1-8 spliced in after SOI as an APP1 segment
    (after a JFIF APP0); 5-8 swap the sides, in the decode and in
    image_size."""
    path = tmp_path / "o.jpg"
    write_jpeg(path, sample_image(37, 21), [
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]])
    data = path.read_bytes()
    app0_end = 4 + struct.unpack(">H", data[4:6])[0]
    path.write_bytes(data[:app0_end] + exif_app1(orientation, little_endian)
                     + data[app0_end:])
    assert_decodes_as_jax(path)
    h, w = dataset.decode_frame(str(path)).shape[:2]
    assert (h, w) == ((37, 21) if orientation >= 5 else (21, 37))


def test_jpeg_refusals(tmp_path):
    """A progressive JPEG decodes as cv2 decodes it, one whose scan header
    breaks the progressive rules raises; arithmetic, lossless, 12-bit and
    CMYK JPEGs and files of a kind the port does not read raise ValueError
    naming the file (and, for a JPEG, the marker or field)."""
    path = tmp_path / "p.jpg"
    write_jpeg(path, sample_image(33, 17), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert_decodes_as_jax(path)
    prog = path.read_bytes()
    sos = prog.index(b"\xff\xda")
    ns = prog[sos + 4]
    bad_scan = bytearray(prog)
    bad_scan[sos + 5 + 2 * ns + 1] = 5          # a DC scan with Se 5
    (tmp_path / "ps.jpg").write_bytes(bytes(bad_scan))
    with pytest.raises(ValueError,
                       match=r"ps\.jpg: bad progressive scan.*Se 5"):
        dataset.decode_frame(str(tmp_path / "ps.jpg"))
    base = tmp_path / "b.jpg"
    write_jpeg(base, sample_image(33, 17), [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = base.read_bytes()
    sof = data.index(b"\xff\xc0")
    for marker, what in ((0xC9, "arithmetic"), (0xC3, "lossless"),
                         (0xC5, "hierarchical")):
        bad = tmp_path / f"m{marker:02x}.jpg"
        bad.write_bytes(data[:sof + 1] + bytes([marker]) + data[sof + 2:])
        with pytest.raises(ValueError, match=f"{what}.*0xFF{marker:02X}"):
            dataset.decode_frame(str(bad))
    twelve = tmp_path / "t.jpg"
    twelve.write_bytes(data[:sof + 4] + b"\x0c" + data[sof + 5:])
    with pytest.raises(ValueError, match="12-bit"):
        dataset.decode_frame(str(twelve))
    from PIL import Image
    cmyk = tmp_path / "c.jpg"
    Image.fromarray(sample_image(33, 17)).convert("CMYK").save(cmyk)
    with pytest.raises(ValueError, match="CMYK"):
        dataset.decode_frame(str(cmyk))
    other = tmp_path / "x.jpg"
    other.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a JPEG, PNG, BMP or TIFF"):
        dataset.decode_frame(str(other))
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="cut.jpg"):
        dataset.decode_frame(str(cut))


class BaselineJpeg:
    """A small baseline JPEG encoder for the layouts cv2 does not write:
    one scan per component (non-interleaved) with the Huffman tables and a
    quantisation table redefined between scans, restart intervals in
    single-block MCUs, or one interleaved scan.  Its tables are the ones
    cv2 writes (read from a cv2 file); cv2 is the oracle of the decode."""

    ZIGZAG = np.array([
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
        33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57,
        50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
        39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

    def __init__(self, tmp_path):
        ref = tmp_path / "tables.jpg"
        write_jpeg(ref, sample_image(16, 16), [cv2.IMWRITE_JPEG_QUALITY, 75])
        data, pos = ref.read_bytes(), 2
        self.dqt, self.dht = {}, {}
        while data[pos + 1] != 0xDA:
            marker = data[pos + 1]
            n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
            body, p = data[pos + 4:pos + 2 + n], 0
            while marker in (0xDB, 0xC4) and p < len(body):
                if marker == 0xDB:
                    self.dqt[body[p] & 15] = np.frombuffer(
                        body[p + 1:p + 65], np.uint8).astype(int)
                    p += 65
                else:
                    counts = list(body[p + 1:p + 17])
                    k = sum(counts)
                    self.dht[(body[p] >> 4, body[p] & 15)] = (
                        counts, list(body[p + 17:p + 17 + k]))
                    p += 17 + k
            pos += 2 + n
        t = np.array([[np.sqrt((1 if u else 0.5) / 4)
                       * np.cos((2 * x + 1) * u * np.pi / 16)
                       for x in range(8)] for u in range(8)])
        self.dct = t

    @staticmethod
    def codes(counts, symbols):
        table, code, k = {}, 0, 0
        for length, n in enumerate(counts, 1):
            for _ in range(n):
                table[symbols[k]] = (code, length)
                code, k = code + 1, k + 1
            code <<= 1
        return table

    def coefficients(self, plane, bw, bh, quant_zigzag):
        """(bh, bw, 64) quantised coefficients in zigzag order, the plane
        padded by edge replication."""
        padded = np.pad(plane.astype(float) - 128,
                        ((0, bh * 8 - plane.shape[0]),
                         (0, bw * 8 - plane.shape[1])), mode="edge")
        blocks = padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = self.dct @ blocks @ self.dct.T
        q = np.zeros(64)
        q[self.ZIGZAG] = quant_zigzag
        return np.round(coef.reshape(bh, bw, 64)[..., self.ZIGZAG]
                        / q[self.ZIGZAG]).astype(int)

    @staticmethod
    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    def dht_segment(self, cls, tid, which):
        counts, symbols = self.dht[(cls, which)]
        return self.segment(0xC4, bytes([cls << 4 | tid] + counts + symbols))

    def encode(self, rgb, sampling, interleaved, restart, tables_by_scan):
        """sampling: ((h, v) of Y, Cb, Cr); tables_by_scan: for each
        non-interleaved scan, which of cv2's table pairs (0 luma, 1
        chroma) is loaded as table 0 before it."""
        h, w = rgb.shape[:2]
        ycc = cv2.cvtColor(rgb, cv2.COLOR_RGB2YCrCb)[..., [0, 2, 1]]
        hmax = max(s[0] for s in sampling)
        vmax = max(s[1] for s in sampling)
        mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        comps = []
        for c, (hs, vs) in enumerate(sampling):
            cw, ch = -(-w * hs // hmax), -(-h * vs // vmax)
            plane = cv2.resize(ycc[..., c], (cw, ch),
                               interpolation=cv2.INTER_AREA)
            # chroma quantised with cv2's chroma table, except Cr in the
            # scan layout: table 2, cv2's luma table, defined just before
            # Cr's scan
            tq = 0 if c == 0 else (2 if c == 2 and not interleaved else 1)
            quant = self.dqt[0] if tq in (0, 2) else self.dqt[1]
            comps.append(dict(hs=hs, vs=vs, cw=cw, ch=ch, tq=tq,
                              coef=self.coefficients(plane, mx * hs, my * vs,
                                                     quant), quant=quant))
        head = b"\xff\xd8"
        head += self.segment(0xDB, bytes([0]) + bytes(self.dqt[0].tolist()))
        head += self.segment(0xDB, bytes([1]) + bytes(self.dqt[1].tolist()))
        head += self.segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + b"".join(
            bytes([c + 1, k["hs"] << 4 | k["vs"], k["tq"] if k["tq"] < 2
                   else 2]) for c, k in enumerate(comps)))
        if restart:
            head += self.segment(0xDD, struct.pack(">H", restart))
        out = head
        if interleaved:
            out += self.dht_segment(0, 0, 0) + self.dht_segment(1, 0, 0)
            out += self.dht_segment(0, 1, 1) + self.dht_segment(1, 1, 1)
            mcus = [[(c, my_ * k["vs"] + v, mx_ * k["hs"] + u)
                     for c, k in enumerate(comps)
                     for v in range(k["vs"]) for u in range(k["hs"])]
                    for my_ in range(my) for mx_ in range(mx)]
            tables = {c: (0 if c == 0 else 1) for c in range(3)}
            out += self.scan(comps, [0, 1, 2], mcus, tables, restart)
        else:
            for c, which in enumerate(tables_by_scan):
                k = comps[c]
                if c == 2:
                    out += self.segment(0xDB, bytes([2]) + bytes(
                        self.dqt[0].tolist()))
                out += self.dht_segment(0, 0, which)
                out += self.dht_segment(1, 0, which)
                mcus = [[(c, by, bx)] for by in range(-(-k["ch"] // 8))
                        for bx in range(-(-k["cw"] // 8))]
                out += self.scan(comps, [c], mcus, {c: which}, restart)
        return out + b"\xff\xd9"

    def scan(self, comps, ids, mcus, which, restart):
        sos = bytes([len(ids)]) + b"".join(bytes([c + 1, 0 if which[c] == 0
                                                  or len(ids) == 1 else 0x11])
                                          for c in ids) + bytes([0, 63, 0])
        dc = {c: self.codes(*self.dht[(0, which[c])]) for c in ids}
        ac = {c: self.codes(*self.dht[(1, which[c])]) for c in ids}
        bits, pred, rst = [], {c: 0 for c in ids}, 0

        def put(value, length):
            bits.extend((value >> (length - 1 - i)) & 1 for i in range(length))

        def magnitude(v):
            s = int(abs(v)).bit_length()
            return s, (v if v >= 0 else v + (1 << s) - 1)

        data = bytearray()

        def flush():
            while len(bits) % 8:
                bits.append(1)
            for i in range(0, len(bits), 8):
                byte = int("".join(map(str, bits[i:i + 8])), 2)
                data.append(byte)
                if byte == 0xFF:
                    data.append(0)
            bits.clear()

        for m, blocks in enumerate(mcus):
            if restart and m and m % restart == 0:
                flush()
                data += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                pred = {c: 0 for c in ids}
            for c, by, bx in blocks:
                z = comps[c]["coef"][by, bx]
                s, v = magnitude(z[0] - pred[c])
                pred[c] = z[0]
                put(*dc[c][s])
                put(v, s)
                run = 0
                for k in range(1, 64):
                    if z[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        put(*ac[c][0xF0])
                        run -= 16
                    s, v = magnitude(z[k])
                    put(*ac[c][run << 4 | s])
                    put(v, s)
                    run = 0
                if run:
                    put(*ac[c][0x00])
        flush()
        return self.segment(0xDA, sos) + bytes(data)


@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("layout", ["interleaved", "scans"])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_jpeg_scan_layouts_match_cv2(tmp_path, sampling, layout, restart):
    """One interleaved scan, or one scan per component with the Huffman
    tables (table 0: luma, then chroma) and a quantisation table (Cr's,
    defined just before its scan) changing between scans; restart markers
    every 5 MCUs (single blocks in the scans layout); odd sides."""
    y = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[sampling]
    enc = BaselineJpeg(tmp_path)
    # blurred, so that the chroma subsampling alone loses little
    rgb = cv2.GaussianBlur(sample_image(53, 37, seed=11), (5, 5), 2)
    path = tmp_path / "s.jpg"
    path.write_bytes(enc.encode(rgb, (y, (1, 1), (1, 1)),
                                layout == "interleaved", restart, (0, 1, 1)))
    if restart:
        assert restart_markers(path) >= 2
    assert_decodes_as_jax(path)
    # the encoder is sound: its decode is about as near the image as
    # cv2's own encode at the tables' quality (75) and this sampling
    ref = tmp_path / "ref.jpg"
    write_jpeg(ref, rgb, [cv2.IMWRITE_JPEG_QUALITY, 75,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          SAMPLING[sampling]])
    err, ref_err = (np.abs(dataset.decode_frame(str(p)).astype(int)
                           - rgb).mean() for p in (path, ref))
    assert err < ref_err + 2, (err, ref_err)


def png_filter_types(path):
    data = Path(path).read_bytes()
    w, h, _, ctype = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = 1 + w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("filt", list(PNG_FILTERS))
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_png_matches_cv2(tmp_path, channels, filt):
    """8-bit PNG gray, RGB and RGBA (alpha dropped) under each of the
    five row filters and libpng's adaptive choice."""
    img = sample_image(57, 40, seed=channels)
    if channels == 4:
        img = np.concatenate([img, sample_image(57, 40, seed=9)[..., :1]], -1)
    elif channels == 1:
        img = img[..., 0]
    path = tmp_path / "f.png"
    flag, want_types = PNG_FILTERS[filt]
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_FILTER, flag])
    if want_types is not None:
        assert png_filter_types(path) == want_types
    assert_decodes_as_jax(path)


def test_png_gray_alpha_and_refusals(tmp_path):
    """Gray + alpha (PIL writes it), 16-bit and palette PNGs equal cv2's
    decode; a PNG flagged interlaced whose data is not Adam7, a colour
    type PNG does not have and an unknown row filter raise ValueError
    naming the file and the field."""
    from PIL import Image
    img = sample_image(31, 19)
    la = tmp_path / "la.png"
    Image.fromarray(np.ascontiguousarray(img[..., :2])).save(la)   # "LA"
    assert_decodes_as_jax(la)
    deep = tmp_path / "d.png"
    cv2.imwrite(str(deep), img.astype(np.uint16) * 257)
    assert_decodes_as_jax(deep)
    pal = tmp_path / "p.png"
    Image.fromarray(img).convert("P").save(pal)
    assert_decodes_as_jax(pal)

    def with_ihdr_byte(src, at, value):
        data = bytearray(src.read_bytes())
        data[at] = value
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        return bytes(data)
    inter = tmp_path / "i.png"
    inter.write_bytes(with_ihdr_byte(la, 28, 1))   # IHDR's interlace method
    with pytest.raises(ValueError, match=r"i\.png: PNG (data of|filter)"):
        dataset.decode_frame(str(inter))
    five = tmp_path / "c5.png"
    five.write_bytes(with_ihdr_byte(la, 25, 5))    # IHDR's colour type
    with pytest.raises(ValueError, match=r"c5\.png: PNG colour type 5"):
        dataset.decode_frame(str(five))
    data = la.read_bytes()
    start = data.index(b"IDAT") + 4
    n = struct.unpack(">I", data[start - 8:start - 4])[0]
    raw = bytearray(zlib.decompress(data[start:start + n]))
    raw[0] = 7                                     # row 0's filter type
    body = zlib.compress(bytes(raw))
    idat = (struct.pack(">I", len(body)) + b"IDAT" + body
            + struct.pack(">I", zlib.crc32(b"IDAT" + body)))
    (tmp_path / "f7.png").write_bytes(data[:start - 8] + idat
                                      + data[start + n + 4:])
    with pytest.raises(ValueError, match=r"f7\.png: PNG filter type 7"):
        dataset.decode_frame(str(tmp_path / "f7.png"))


@pytest.mark.parametrize("short_palette", [False, True],
                         ids=["full", "short"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_png_expands_as_pil(tmp_path, bits, short_palette):
    """read_image_mode keeps a palette PNG's indices at each bit depth
    (the file's IHDR says so) and palette_to_rgb expands them as PIL's
    convert("RGB"), indices past a short palette black."""
    from PIL import Image
    rng = np.random.default_rng(bits)
    n = 1 << bits
    idx = rng.integers(0, n, (11, 29), np.uint8)
    im = Image.fromarray(idx, "P")
    entries = max(n - 1, 1) if short_palette else n
    im.putpalette(rng.integers(0, 255, 3 * entries, np.uint8).tolist())
    path = tmp_path / "p.png"
    im.save(path, bits=bits)
    assert path.read_bytes()[24] == bits            # IHDR's bit depth
    mode, got, palette = image_io.read_image_mode(str(path))
    pil = Image.open(path)
    assert mode == pil.mode == "P"
    np.testing.assert_array_equal(got, np.asarray(pil))
    np.testing.assert_array_equal(image_io.palette_to_rgb(got, palette),
                                  np.asarray(pil.convert("RGB")))


def test_read_image_mode_keeps_the_mode(tmp_path):
    """Each mode as PIL's Image.open gives it: L, LA, RGB and RGBA PNGs,
    RGB and grayscale JPEGs (no EXIF orientation applied, as PIL)."""
    from PIL import Image
    img = sample_image(23, 17)
    four = np.concatenate([img, img[..., :1]], 2)
    for mode, arr in (("L", img[..., 0]), ("LA", img[..., :2]),
                      ("RGB", img), ("RGBA", four)):
        path = tmp_path / f"{mode}.png"
        Image.fromarray(np.ascontiguousarray(arr), mode).save(path)
        got_mode, got, palette = image_io.read_image_mode(str(path))
        assert got_mode == mode and palette is None
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    for name, arr in (("rgb.jpg", img[..., ::-1]), ("gray.jpg",
                                                     img[..., 0])):
        path = tmp_path / name
        cv2.imwrite(str(path), np.ascontiguousarray(arr))
        pil = Image.open(path)
        got_mode, got, _ = image_io.read_image_mode(str(path))
        assert got_mode == pil.mode
        np.testing.assert_array_equal(got, np.asarray(pil))


def test_png_writer_and_sizes(tmp_path):
    """image_io.write_png stores the pixels cv2 reads back; the synthetic
    video's png format (no cv2) decodes to its npy frames; prepare_data's
    sizes equal cv2's decode."""
    img = sample_image(45, 23)
    image_io.write_png(tmp_path / "w.png", img)
    assert (jax_dataset.decode_frame(str(tmp_path / "w.png")) == img).all()
    kw = dict(num_frames=2, num_persons=2, width=48, height=40, seed=3)
    for fmt in ("npy", "png"):
        make_synthetic_video(str(tmp_path / fmt), img_format=fmt, **kw)
    for f in ("000000", "000001"):
        want = np.load(tmp_path / "npy" / "images" / "000001" / f"{f}.npy")
        png = str(tmp_path / "png" / "images" / "000001" / f"{f}.png")
        assert (dataset.decode_frame(png) == want).all()
        assert (jax_dataset.decode_frame(png) == want).all()
        assert prepare_data._img_size(png) == (48, 40)
    jpg = tmp_path / "s.jpg"
    write_jpeg(jpg, sample_image(45, 23), [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert prepare_data._img_size(str(jpg)) == (45, 23)


def frame_variants(tmp_path):
    """A small synthetic video as JPEG, PNG and the .npy of cv2's decode
    of the JPEG and of the PNG: (root, {kind: annotation})."""
    root, ann = make_synthetic_video(str(tmp_path), num_frames=3,
                                     num_persons=2, width=64, height=48,
                                     seed=4)
    with open(os.path.join(root, ann)) as f:
        base = json.load(f)
    anns = {}
    for kind in ("jpg", "png", "jpg_npy", "png_npy"):
        d = json.loads(json.dumps(base))
        for im in d["images"]:
            npy = os.path.join(root, im["file_name"])
            stem = im["file_name"][:-len(".npy")]
            rgb = np.load(npy)
            if kind == "jpg":
                write_jpeg(os.path.join(root, stem + ".jpg"), rgb,
                           FIXTURE_JPEG)
            elif kind == "png":
                cv2.imwrite(os.path.join(root, stem + ".png"),
                            cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
            else:
                src = os.path.join(root, stem + "." + kind[:3])
                np.save(os.path.join(root, f"{stem}_{kind}.npy"),
                        jax_dataset.decode_frame(src))
            im["file_name"] = stem + ("." + kind if "_" not in kind
                                      else f"_{kind}.npy")
        anns[kind] = f"annotations/{kind}.json"
        with open(os.path.join(root, anns[kind]), "w") as f:
            json.dump(d, f)
    return root, anns


def test_frame_paths_over_jpeg_and_png(tmp_path):
    """The resident dataset (load_frames, the JPEGs decoded on several
    threads) and the FrameStore over JPEG and PNG frames equal the same
    over the .npy of cv2's decode, and the JAX package's load_frames."""
    root, anns = frame_variants(tmp_path)
    for kind in ("jpg", "png"):
        cfg = {"TYPE": "Posetrack21", "ROOT": root, "ANN": anns[kind]}
        ds = build_dataset(cfg)
        ref = build_dataset(dict(cfg, ANN=anns[f"{kind}_npy"]))
        frames = ds.load_frames()
        assert frames.shape == (3, 48, 64, 3)
        assert (frames == ref.load_frames()).all()
        assert (frames == jax_dataset.build_dataset(cfg).load_frames()).all()
        store, ref_store = ds.frame_store(), ref.frame_store()
        for i in range(3):
            assert (store.get(i) == ref_store.get(i)).all()
            assert (store.get(i) == frames[i]).all()
        assert isinstance(store, FrameStore)


def test_read_images_threads_agree(tmp_path):
    """Many JPEGs (and a PNG among them) on several threads equal one at
    a time."""
    paths = []
    for i, (w, h) in enumerate([(64, 48), (17, 13), (120, 33)] * 3):
        p = tmp_path / f"{i}.jpg"
        write_jpeg(p, sample_image(w, h, seed=i), [cv2.IMWRITE_JPEG_QUALITY,
                                                 80 + i])
        paths.append(str(p))
    image_io.write_png(tmp_path / "x.png", sample_image(9, 7))
    paths.insert(4, str(tmp_path / "x.png"))
    many = image_io.read_images(paths, num_threads=4)
    assert all((a == image_io.read_images([p], num_threads=1)[0]).all()
               for a, p in zip(many, paths))


def test_jpeg_build_key_follows_the_compiler(monkeypatch):
    """The decoder's library is named by its source, flags and g++
    --version, as the host warp's is."""
    paths = []
    for version in ("g++ 12.2.0", "g++ 13.3.0"):
        monkeypatch.setattr(native_warp, "compiler_version",
                            lambda cxx, v=version: v)
        paths.append(native_warp.host_library_path(image_io.SOURCE,
                                                   "jpeg_decode"))
    assert paths[0] != paths[1]
    assert paths[0].parent == native_warp.BUILD_DIR
    assert paths[0].name.startswith("libjpeg_decode-")


def test_fixture_hashes_match_cv2():
    """The committed video: cv2's RGB decode of each frame has the
    recorded SHA-256, and so has the port's."""
    with open(FIXTURE / "decoded_sha256.json") as f:
        recorded = json.load(f)
    assert len(recorded) == FIXTURE_VIDEO["num_frames"]
    paths = [str(FIXTURE / name) for name in recorded]
    ours = dataset.decode_frames(paths)
    for (name, digest), path, img in zip(recorded.items(), paths, ours):
        assert rgb_sha256(jax_dataset.decode_frame(path)) == digest, name
        assert rgb_sha256(img) == digest, name
        assert img.shape == (360, 640, 3)


def test_fixture_is_the_seeded_video(tmp_path):
    """The committed annotation is the generator's (its .npy names made
    .jpg), and each JPEG keeps the generator's frame: its 8x8 block means
    (JPEG's DC terms, which quality 90 keeps where 4:2:0 sampling drops
    the background's per-pixel chroma noise) within 1 of the frame's on
    average."""
    root, ann = make_synthetic_video(str(tmp_path), **FIXTURE_VIDEO)
    with open(os.path.join(root, ann)) as f:
        want = json.load(f)
    for im in want["images"]:
        im["file_name"] = im["file_name"].replace(".npy", ".jpg")
    with open(FIXTURE / FIXTURE_ANN) as f:
        assert json.load(f) == want
    ds = build_dataset({"TYPE": "Posetrack21", "ROOT": str(FIXTURE),
                        "ANN": FIXTURE_ANN})
    assert len(ds) == 128
    frames = ds.load_frames()
    for i, im in enumerate(want["images"]):
        npy = np.load(os.path.join(root, im["file_name"][:-4] + ".npy"))
        blocks = [a.astype(float).reshape(45, 8, 80, 8, 3).mean((1, 3))
                  for a in (frames[i], npy)]
        err = np.abs(blocks[0] - blocks[1]).mean()
        assert err < 1, (im["file_name"], err)


def write_fixture(dest=FIXTURE):
    """Writes the committed video anew (see the module's docstring)."""
    dest = Path(dest)
    with tempfile.TemporaryDirectory() as tmp:
        root, ann = make_synthetic_video(tmp, **FIXTURE_VIDEO)
        with open(os.path.join(root, ann)) as f:
            data = json.load(f)
        shutil.rmtree(dest, ignore_errors=True)
        hashes = {}
        for im in data["images"]:
            rgb = np.load(os.path.join(root, im["file_name"]))
            im["file_name"] = im["file_name"].replace(".npy", ".jpg")
            out = dest / im["file_name"]
            out.parent.mkdir(parents=True, exist_ok=True)
            write_jpeg(out, rgb, FIXTURE_JPEG)
            hashes[im["file_name"]] = rgb_sha256(
                jax_dataset.decode_frame(str(out)))
        (dest / FIXTURE_ANN).parent.mkdir(parents=True, exist_ok=True)
        with open(dest / FIXTURE_ANN, "w") as f:
            json.dump(data, f)
        with open(dest / "decoded_sha256.json", "w") as f:
            json.dump(hashes, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    write_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
