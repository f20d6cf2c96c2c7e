"""The port's file formats against the JAX package's (twins of
tests/test_frame_utils.py): every reader returns JAX's arrays bit for bit,
each package reads what the other writes, PNGs with rows of all five
filter types decode to their pixels, and PIL's adaptively filtered PNGs
(Sub, Up and Paeth rows) to PIL's own."""

import numpy as np
import pytest
from PIL import Image

from raft_tpu.data import frame_utils as jfu
from raft_tpu.data import png16 as jpng
from raft_tpu_torch.data import frame_utils as tfu
from raft_tpu_torch.data import png16 as tpng


def _equal(got, want):
    assert type(got) is type(want)
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_flo_both_ways(tmp_path):
    flow = np.random.RandomState(0).randn(13, 17, 2).astype(np.float32)
    for name, writer in (("j.flo", jfu.write_flo), ("t.flo", tfu.write_flo)):
        p = str(tmp_path / name)
        writer(p, flow)
        _equal(tfu.read_flo(p), jfu.read_flo(p))
        _equal(tfu.read_flo(p), flow)
    assert (tmp_path / "j.flo").read_bytes() == (tmp_path / "t.flo").read_bytes()


def test_flo_bad_magic(tmp_path):
    p = tmp_path / "bad.flo"
    p.write_bytes(b"\x00" * 32)
    with pytest.raises(ValueError, match="bad .flo magic"):
        tfu.read_flo(str(p))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("nch", [1, 2, 3, 4])
def test_png_both_ways(tmp_path, dtype, nch):
    rng = np.random.RandomState(1)
    hi = 255 if dtype == np.uint8 else 65535
    shape = (11, 7) if nch == 1 else (11, 7, nch)
    img = rng.randint(0, hi + 1, size=shape).astype(dtype)
    for name, writer in (("j.png", jpng.write_png), ("t.png", tpng.write_png)):
        p = str(tmp_path / name)
        writer(p, img)
        _equal(tpng.read_png(p), jpng.read_png(p))
        _equal(tpng.read_png(p), img)


def _png_from_rows(path, rows, w, depth, nch):
    """A PNG file of filtered scanlines ``rows`` (each: a filter type
    byte, then the row's bytes)."""
    import struct
    import zlib

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[nch]
    ihdr = struct.pack(">IIBBBBB", w, len(rows), depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(
                    np.asarray(rows, np.uint8).tobytes()))
                + chunk(b"IEND", b""))


def _encode_filtered(path, img, ftypes):
    """A PNG whose row y carries filter ``ftypes[y % len(ftypes)]``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), encoded here from the
    PNG specification."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, nch = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    bpp = nch * depth // 8
    raw = np.frombuffer(img.astype(">u2" if depth == 16 else np.uint8)
                        .tobytes(), np.uint8).reshape(h, w * bpp)
    raw = raw.astype(np.int64)
    rows = []
    for y in range(h):
        x = raw[y]
        up = raw[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
        ft = ftypes[y % len(ftypes)]
        pred = [0, a, up, (a + up) >> 1, paeth][ft]
        rows.append(np.concatenate([[ft], (x - pred) & 0xFF]))
    _png_from_rows(path, rows, w, depth, nch)


@pytest.mark.parametrize("ftypes", [(0, 1, 2, 3, 4, 4, 3, 2, 1), (4,),
                                    (3,), (0, 1, 2, 2, 1)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("nch", [1, 3, 4])
def test_png_every_filter_type(tmp_path, dtype, nch, ftypes):
    """Rows of all five filter types (decoded by anti-diagonals), all
    Paeth, all Average, and None / Sub / Up only (decoded row by row), on
    a tall and a wide image."""
    rng = np.random.RandomState(9)
    hi = 255 if dtype == np.uint8 else 65535
    for hw in ((15, 13), (4, 29)):
        img = rng.randint(0, hi + 1, size=hw + ((nch,) if nch > 1 else ())
                          ).astype(dtype)
        p = str(tmp_path / "f.png")
        _encode_filtered(p, img, list(ftypes))
        _equal(tpng.read_png(p), jpng.read_png(p))
        _equal(tpng.read_png(p), img)


def test_png_bad_filter_type(tmp_path):
    p = str(tmp_path / "bad.png")
    _png_from_rows(p, [[0, 1, 2], [7, 1, 2]], 2, 8, 1)
    for read_png in (tpng.read_png, jpng.read_png):
        with pytest.raises(ValueError, match="bad filter type 7"):
            read_png(p)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_reader_matches_pil_and_jax_on_pil_files(tmp_path, mode):
    """PIL writes adaptively filtered rows; a smooth gradient beside noise
    draws Sub, Up and Paeth (what real KITTI files are full of)."""
    import zlib

    rng = np.random.RandomState(2)
    g = np.add.outer(np.arange(33), np.arange(47)) % 256
    img = np.stack([g, g[::-1], rng.randint(0, 256, g.shape),
                    (g * 3) % 256], axis=-1).astype(np.uint8)
    img = img[..., :3] if mode == "RGB" else img
    p = str(tmp_path / f"pil_{mode}.png")
    Image.fromarray(img).save(p)
    raw = open(p, "rb").read()
    start = raw.index(b"IDAT") + 4
    length = int.from_bytes(raw[start - 8:start - 4], "big")
    rows = np.frombuffer(zlib.decompress(raw[start:start + length]),
                         np.uint8).reshape(img.shape[0], -1)
    assert 4 in set(rows[:, 0].tolist()), rows[:, 0]
    with Image.open(p) as im:
        want = np.array(im)
    _equal(tpng.read_png(p), jpng.read_png(p))
    _equal(tpng.read_png(p), want)


def test_png_errors(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tpng.read_png(str(p))
    with pytest.raises(TypeError, match="uint8/uint16"):
        tpng.write_png(str(p), np.zeros((2, 2), np.float32))


def test_kitti_flow_both_ways(tmp_path):
    rng = np.random.RandomState(3)
    flow = (rng.rand(9, 12, 2).astype(np.float32) - 0.5) * 100
    for name, writer in (("j.png", jfu.write_flow_kitti),
                         ("t.png", tfu.write_flow_kitti)):
        p = str(tmp_path / name)
        writer(p, flow)
        _equal(tfu.read_flow_kitti(p), jfu.read_flow_kitti(p))
        back, valid = tfu.read_flow_kitti(p)
        assert np.abs(back - flow).max() <= 1.0 / 64 + 1e-6
        assert (valid == 1).all()
    # sparse ground truth: a third of the pixels invalid
    png = np.concatenate([(64.0 * flow + 2 ** 15),
                          (rng.rand(9, 12, 1) > 1 / 3)], -1).astype(np.uint16)
    p = str(tmp_path / "sparse.png")
    jpng.write_png(p, png)
    _equal(tfu.read_flow_kitti(p), jfu.read_flow_kitti(p))


def test_disp_kitti_matches_jax(tmp_path):
    disp = np.random.RandomState(8).randint(0, 40000, (9, 12)).astype(np.uint16)
    disp[::3] = 0
    p = str(tmp_path / "d.png")
    jpng.write_png(p, disp)
    _equal(tfu.read_disp_kitti(p), jfu.read_disp_kitti(p))


def test_pfm_both_endians_and_writers(tmp_path):
    rng = np.random.RandomState(4)
    data = rng.rand(6, 5, 3).astype(np.float32)
    for scale, order in [("-1.0", "<f4"), ("1.0", ">f4")]:
        p = tmp_path / f"s{scale}.pfm"
        with open(p, "wb") as f:
            f.write(b"PF\n5 6\n" + scale.encode() + b"\n")
            np.flipud(data).astype(order).tofile(f)
        _equal(tfu.read_pfm(str(p)), jfu.read_pfm(str(p)))
        _equal(tfu.read_pfm(str(p)), data)
    for shape in [(6, 5, 3), (6, 5)]:
        d = rng.rand(*shape).astype(np.float32)
        for name, writer in (("j.pfm", jfu.write_pfm),
                             ("t.pfm", tfu.write_pfm)):
            p = str(tmp_path / f"{len(shape)}{name}")
            writer(p, d)
            _equal(tfu.read_pfm(p), jfu.read_pfm(p))
            _equal(tfu.read_pfm(p), d)
    p = tmp_path / "bad.pfm"
    p.write_bytes(b"P6\n")
    with pytest.raises(ValueError, match="not a PFM"):
        tfu.read_pfm(str(p))


def test_read_gen_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    flow = rng.randn(4, 5, 2).astype(np.float32)
    paths = {"f.flo": lambda p: jfu.write_flo(p, flow),
             "f.pfm": lambda p: jfu.write_pfm(p, rng.rand(4, 5, 3)),
             "g.pfm": lambda p: jfu.write_pfm(p, rng.rand(4, 5)),
             "a.npy": lambda p: np.save(p, rng.rand(3, 2)),
             "i.png": lambda p: Image.fromarray(
                 rng.randint(0, 256, (4, 5, 3), np.uint8)).save(p),
             "i.ppm": lambda p: Image.fromarray(
                 rng.randint(0, 256, (4, 5, 3), np.uint8)).save(p),
             "i.jpg": lambda p: Image.fromarray(
                 rng.randint(0, 256, (4, 5), np.uint8)).save(p)}
    for name, write in paths.items():
        p = str(tmp_path / name)
        write(p)
        _equal(tfu.read_gen(p), jfu.read_gen(p))
    assert tfu.read_gen(str(tmp_path / "f.pfm")).shape == (4, 5, 2)
    with pytest.raises(ValueError, match="unsupported extension"):
        tfu.read_gen(str(tmp_path / "x.txt"))
