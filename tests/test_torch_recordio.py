"""The port's ``recordio`` (mxnet_tpu_torch) against the reference's
(mxnet_tpu), on the CPU:

- both packages write the same records (scalar and vector labels through
  ``pack``, images through ``pack_img``, payloads of every length modulo
  4) into ``.rec`` and ``.idx`` files that are byte for byte the same;
- each package reads the other's files, sequentially and by key in any
  order, to the same headers and payloads;
- ``unpack_img`` gives the same pixels (cv2 here), and a smooth image
  survives a JPEG round trip at quality 95 above 40 dB PSNR;
- a record with a bad magic raises, and a pickled reader reopens.
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx


def _image(seed, h=20, w=28):
    """A smooth BGR uint8 image (a few low-frequency waves)."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        fy, fx, ph = r.uniform(0.02, 0.1, 3)
        img[..., c] = 128 + 90 * np.sin(fy * y + fx * x + 6 * ph)
    return np.clip(img, 0, 255).astype(np.uint8)


def _records(pkg):
    """``(key, record)`` pairs of every kind."""
    rio = pkg.recordio
    out = []
    for k in range(6):
        payload = bytes(range(k * 3 + 1))           # lengths 1, 4, 7, ...
        out.append((k, rio.pack(rio.IRHeader(0, float(k) + 0.5, k, 0),
                                payload)))
    out.append((6, rio.pack(rio.IRHeader(0, [1.0, 2.5, -3.0], 6, 7),
                            b"vector")))
    for k in (7, 8):
        out.append((k, rio.pack_img(rio.IRHeader(0, float(k), k, 0),
                                    _image(k), quality=95)))
    return out


def _write(pkg, tmp_path, tag):
    rec, idx = str(tmp_path / (tag + ".rec")), str(tmp_path / (tag + ".idx"))
    w = pkg.recordio.MXIndexedRecordIO(idx, rec, "w")
    for k, r in _records(pkg):
        w.write_idx(k, r)
    w.close()
    return rec, idx


def test_written_files_are_byte_identical(tmp_path):
    port = _write(tmx, tmp_path, "port")
    ref = _write(mx, tmp_path, "ref")
    for a, b in zip(port, ref):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_sequential_writer_matches(tmp_path):
    paths = {}
    for pkg, tag in ((tmx, "port"), (mx, "ref")):
        paths[tag] = str(tmp_path / (tag + ".rec"))
        w = pkg.recordio.MXRecordIO(paths[tag], "w")
        for _, r in _records(pkg):
            w.write(r)
        w.close()
    with open(paths["port"], "rb") as fa, open(paths["ref"], "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("writer,reader", [(mx, tmx), (tmx, mx)])
def test_each_package_reads_the_others_files(tmp_path, writer, reader):
    rec, idx = _write(writer, tmp_path, "w")
    want = dict(_records(writer))
    r = reader.recordio.MXIndexedRecordIO(idx, rec, "r")
    try:
        assert r.keys == list(range(9))
        order = [5, 0, 8, 3, 3, 7, 1, 6, 2, 4]
        for k in order:
            assert r.read_idx(k) == want[k]
        r.reset()
        seq = []
        while True:
            s = r.read()
            if s is None:
                break
            seq.append(s)
        assert seq == [want[k] for k in range(9)]
    finally:
        r.close()


def test_unpack_matches_the_reference(tmp_path):
    for k, rec in _records(tmx):
        h1, s1 = tmx.recordio.unpack(rec)
        h2, s2 = mx.recordio.unpack(rec)
        assert s1 == s2
        assert (h1.flag, h1.id, h1.id2) == (h2.flag, h2.id, h2.id2)
        np.testing.assert_array_equal(np.asarray(h1.label),
                                      np.asarray(h2.label))
    h, _ = tmx.recordio.unpack(_records(tmx)[6][1])
    np.testing.assert_array_equal(h.label, np.float32([1.0, 2.5, -3.0]))
    assert h.flag == 0 and h.id2 == 7


def test_unpack_img_pixels_match_and_round_trip_is_close():
    img = _image(3, 64, 80)
    rec = tmx.recordio.pack_img((0, 4.0, 9, 0), img, quality=95)
    assert rec == mx.recordio.pack_img((0, 4.0, 9, 0), img, quality=95)
    h1, a = tmx.recordio.unpack_img(rec, iscolor=1)
    h2, b = mx.recordio.unpack_img(rec, iscolor=1)
    np.testing.assert_array_equal(a, b)
    assert h1.label == h2.label == 4.0 and a.shape == (64, 80, 3)
    mse = np.mean((a.astype(np.float64) - img) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) > 40.0


def test_bad_magic_raises_and_reader_pickles(tmp_path):
    rec, idx = _write(tmx, tmp_path, "p")
    r = tmx.recordio.MXIndexedRecordIO(idx, rec, "r")
    r2 = pickle.loads(pickle.dumps(r))
    try:
        assert r2.read_idx(4) == r.read_idx(4)
    finally:
        r.close()
        r2.close()
    raw = bytearray(open(rec, "rb").read())
    raw[0] ^= 0xFF
    bad = tmp_path / "bad.rec"
    bad.write_bytes(bytes(raw))
    r = tmx.recordio.MXRecordIO(str(bad), "r")
    try:
        with pytest.raises(tmx.MXNetError, match="magic"):
            r.read()
    finally:
        r.close()
