"""``gluon.data`` and ``gluon.utils`` in the port against the reference, on
the CPU: the samplers, ``DataLoader`` (threads, order, and no thread left
behind), the record, folder, MNIST and CIFAR datasets over files written
into ``tmp_path``, every vision transform at the same seeded draws, and
the utilities.

Random draws: both packages' transforms take Python's ``random`` and
numpy's global generator, so the tests seed both alike before each call.
Geometric transforms (cv2 on uint8) and the samplers agree exactly; the
float transforms within rtol 1e-6 and 1e-4 absolute on the 0-255 scale
(fp32, a mean or a matrix product summed in another order).  A
``DataLoader`` with one worker gives the batches of one with none bit for
bit, since its draws happen in the same order.
"""
import gc
import gzip
import hashlib
import os
import random
import struct
import sys
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.gluon  # noqa: F401
import mxnet_tpu.gluon.data.vision  # noqa: F401
import mxnet_tpu.gluon.utils  # noqa: F401
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon  # noqa: F401
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.dataloader import WORKER_NAME

cv2 = pytest.importorskip("cv2")
jdata = mx.gluon.data


def _workers():
    return [t for t in threading.enumerate() if t.name.startswith(WORKER_NAME)]


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler(last_batch):
    got, want = [], []
    for pkg, out in ((tdata, got), (jdata, want)):
        s = pkg.BatchSampler(pkg.SequentialSampler(10), 3, last_batch)
        for _ in range(2):
            out.append((len(s), list(s)))
    assert got == want
    if last_batch == "rollover":
        assert got[1][1][0] == [9, 0, 1]


def test_random_sampler_follows_numpy_seed():
    orders = []
    for pkg in (tdata, jdata):
        np.random.seed(3)
        orders.append(list(pkg.RandomSampler(12)))
    assert orders[0] == orders[1] and sorted(orders[0]) == list(range(12))
    with pytest.raises(ValueError, match="last_batch"):
        list(tdata.BatchSampler(tdata.SequentialSampler(4), 3, "other"))


X = np.random.default_rng(0).standard_normal((22, 3)).astype(np.float32)
Y = np.arange(22, dtype=np.float32)


def _batches(loader):
    return [[_np(v) for v in b] for b in loader]


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_matches_reference(workers):
    want = None
    for pkg in (jdata, tdata):
        np.random.seed(5)
        ds = pkg.ArrayDataset(X, Y)
        loader = pkg.DataLoader(ds, batch_size=4, shuffle=True,
                                last_batch="discard",
                                num_workers=0 if pkg is jdata else workers)
        got = _batches(loader)
        if pkg is jdata:
            want = got
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    assert not _workers()


def test_dataloader_batches_are_cpu_arrays_in_order():
    loader = tdata.DataLoader(tdata.ArrayDataset(X, Y), batch_size=5,
                              num_workers=3, prefetch=1)
    batches = list(loader)
    assert len(loader) == len(batches) == 5
    assert all(b[0].context == cpu() for b in batches)
    np.testing.assert_array_equal(
        np.concatenate([b[1].asnumpy() for b in batches]), Y)
    assert not _workers()


def test_dataloader_threads_end_on_drop_and_on_error():
    loader = tdata.DataLoader(tdata.ArrayDataset(X, Y), batch_size=2,
                              num_workers=2)
    it = iter(loader)
    next(it)
    assert len(_workers()) == 2
    del it
    gc.collect()
    assert not _workers()

    class Broken(tdata.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("bad sample %d" % i)
            return X[i]

    it = iter(tdata.DataLoader(Broken(), batch_size=2, num_workers=2))
    next(it)
    next(it)
    with pytest.raises(KeyError, match="bad sample 5"):
        next(it)
    assert not _workers()
    with pytest.raises(StopIteration):
        next(it)


def test_dataloader_stress_more_workers_than_cores():
    """More workers than cores, threads switching every microsecond: every
    batch arrives once, in order, with its own samples."""
    n = 2 * (os.cpu_count() or 2) + 1
    ds = tdata.SimpleDataset([np.full(3, i, np.float32) for i in range(97)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            loader = tdata.DataLoader(ds, batch_size=4, num_workers=n,
                                      prefetch=n)
            got = np.concatenate([b.asnumpy()[:, 0] for b in loader])
            np.testing.assert_array_equal(got, np.arange(97))
    finally:
        sys.setswitchinterval(old)
    assert not _workers()


def _write_rec(path, images, labels):
    from mxnet_tpu_torch import recordio
    rec = recordio.MXIndexedRecordIO(str(path) + ".idx", str(path) + ".rec",
                                     "w")
    for k, (img, lab) in enumerate(zip(images, labels)):
        rec.write_idx(k, recordio.pack_img(recordio.IRHeader(0, lab, k, 0),
                                           img, quality=95))
    rec.close()
    return str(path) + ".rec"


def _images(n, seed=0, h=20, w=24):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_image_record_dataset(tmp_path):
    rec = _write_rec(tmp_path / "data", _images(5), [1.0, 2.0, 0.0, 4.0,
                                                     3.0])
    for flag in (1, 0):
        ref = mx.gluon.data.vision.ImageRecordDataset(rec, flag=flag)
        ds = tdata.vision.ImageRecordDataset(rec, flag=flag)
        assert len(ds) == len(ref) == 5
        for i in range(5):
            (img, lab), (rimg, rlab) = ds[i], ref[i]
            assert img.context == cpu() and lab == rlab
            np.testing.assert_array_equal(img.asnumpy(), rimg.asnumpy())


def test_image_folder_dataset(tmp_path):
    imgs = _images(4, seed=1)
    for k, img in enumerate(imgs):
        d = tmp_path / ("cat" if k % 2 else "dog")
        d.mkdir(exist_ok=True)
        cv2.imwrite(str(d / ("%d.png" % k)), img)
    (tmp_path / "notes.txt").write_text("not a class")
    (tmp_path / "dog" / "x.txt").write_text("not an image")
    with pytest.warns(UserWarning):
        ds = tdata.vision.ImageFolderDataset(str(tmp_path))
    with pytest.warns(UserWarning):
        ref = mx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    assert ds.synsets == ref.synsets == ["cat", "dog"]
    assert ds.items == ref.items
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i][0].asnumpy(),
                                      ref[i][0].asnumpy())
        assert ds[i][1] == ref[i][1]


def _write_idx(root, prefix, n, gz):
    r = np.random.default_rng(2)
    data = r.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = r.integers(0, 10, n, dtype=np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(os.path.join(root, prefix + "-images-idx3-ubyte" + suffix),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + data.tobytes())
    with opener(os.path.join(root, prefix + "-labels-idx1-ubyte" + suffix),
                "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
def test_mnist_files(tmp_path, name):
    _write_idx(str(tmp_path), "train", 7, gz=False)
    _write_idx(str(tmp_path), "t10k", 3, gz=True)
    for train, n in ((True, 7), (False, 3)):
        ds = getattr(tdata.vision, name)(root=str(tmp_path), train=train)
        ref = getattr(mx.gluon.data.vision, name)(root=str(tmp_path),
                                                  train=train)
        assert len(ds) == len(ref) == n
        for i in range(n):
            assert ds[i][0].shape == (28, 28, 1)
            np.testing.assert_array_equal(ds[i][0].asnumpy(),
                                          ref[i][0].asnumpy())
            assert ds[i][1] == ref[i][1]
    with pytest.raises(IOError, match="downloads nothing"):
        tdata.vision.MNIST(root=str(tmp_path / "empty"))


@pytest.mark.parametrize("name,label_bytes", [("CIFAR10", 1),
                                              ("CIFAR100", 2)])
def test_cifar_files(tmp_path, name, label_bytes):
    r = np.random.default_rng(3)
    files = ["data_batch_%d.bin" % i for i in range(1, 6)] \
        if name == "CIFAR10" else ["train.bin"]
    for f in files + (["test_batch.bin"] if name == "CIFAR10"
                      else ["test.bin"]):
        recs = r.integers(0, 256, (2, 3072 + label_bytes), dtype=np.uint8)
        (tmp_path / f).write_bytes(recs.tobytes())
    kw = [{"fine_label": True}, {"fine_label": False}] \
        if name == "CIFAR100" else [{}]
    for extra in kw:
        for train in (True, False):
            ds = getattr(tdata.vision, name)(root=str(tmp_path), train=train,
                                             **extra)
            ref = getattr(mx.gluon.data.vision, name)(
                root=str(tmp_path), train=train, **extra)
            assert len(ds) == len(ref)
            for i in range(len(ds)):
                assert ds[i][0].shape == (32, 32, 3)
                np.testing.assert_array_equal(ds[i][0].asnumpy(),
                                              ref[i][0].asnumpy())
                assert ds[i][1] == ref[i][1]


IMG = np.random.default_rng(4).integers(0, 256, (30, 40, 3), dtype=np.uint8)
EXACT, CLOSE = 0.0, 1e-4


def _t(pkg):
    return pkg.gluon.data.vision.transforms


TRANSFORMS = [
    ("Cast", lambda T: T.Cast("float32"), EXACT),
    ("ToTensor", lambda T: T.ToTensor(), CLOSE),
    ("Normalize", lambda T: T.Compose([T.ToTensor(), T.Normalize(
        (0.4, 0.5, 0.6), (0.2, 0.3, 0.25))]), CLOSE),
    ("Resize", lambda T: T.Resize((17, 13)), EXACT),
    ("Resize_keep_ratio", lambda T: T.Resize(20, keep_ratio=True), EXACT),
    ("CenterCrop", lambda T: T.CenterCrop(24), EXACT),
    ("RandomResizedCrop", lambda T: T.RandomResizedCrop(16), EXACT),
    ("RandomFlipLeftRight", lambda T: T.RandomFlipLeftRight(), EXACT),
    ("RandomFlipTopBottom", lambda T: T.RandomFlipTopBottom(), EXACT),
    ("RandomBrightness", lambda T: T.RandomBrightness(0.3), CLOSE),
    ("RandomContrast", lambda T: T.RandomContrast(0.3), CLOSE),
    ("RandomSaturation", lambda T: T.RandomSaturation(0.3), CLOSE),
    ("RandomHue", lambda T: T.RandomHue(0.2), CLOSE),
    ("RandomColorJitter", lambda T: T.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
     CLOSE),
    ("RandomLighting", lambda T: T.RandomLighting(0.1), CLOSE),
]


@pytest.mark.parametrize("name,make,atol", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_matches_reference(name, make, atol):
    outs = []
    for pkg in (tmx, mx):
        t = make(_t(pkg))
        ctx = {"ctx": cpu()} if pkg is tmx else {}
        res = []
        for seed in range(4):
            random.seed(seed)
            np.random.seed(seed)
            res.append(t(pkg.nd.array(IMG, dtype=np.uint8, **ctx)).asnumpy())
        outs.append(res)
    for got, want in zip(*outs):
        assert got.shape == want.shape
        if atol == EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)


def test_pipeline_through_workers_is_deterministic(tmp_path):
    """A record file through the training transforms: one worker gives
    the batches of none, bit for bit, from the same seeds; they match the
    reference's; four workers give the same labels in the same order."""
    imgs = _images(6, seed=5, h=40, w=50)
    rec = _write_rec(tmp_path / "p", imgs, [float(i) for i in range(6)])
    runs = []
    for pkg, workers in ((tmx, 0), (tmx, 1), (mx, 0), (tmx, 4)):
        T = _t(pkg)
        ds = pkg.gluon.data.vision.ImageRecordDataset(rec).transform_first(
            T.Compose([T.RandomResizedCrop(24), T.RandomFlipLeftRight(),
                       T.ToTensor(), T.Normalize((0.5, 0.5, 0.5),
                                                 (0.25, 0.25, 0.25))]))
        random.seed(7)
        np.random.seed(7)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=3, shuffle=True,
                                           num_workers=workers)
        runs.append(_batches(loader))
    (zero, one, ref, four) = runs
    for a, b in zip(zero, one):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for a, b in zip(zero, ref):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(a[1], b[1])
    assert [b[1].tolist() for b in four] == [b[1].tolist() for b in zero]
    assert not _workers()


def test_split_data_and_load():
    utils = tmx.gluon.utils
    x = tmx.nd.array(np.arange(30, dtype=np.float32).reshape(10, 3),
                     ctx=cpu())
    xr = mx.nd.array(x.asnumpy())
    for kw in ({"num_slice": 5}, {"num_slice": 3, "even_split": False},
               {"num_slice": 3, "batch_axis": 1}):
        got = [s.asnumpy() for s in utils.split_data(x, **kw)]
        want = [s.asnumpy() for s in mx.gluon.utils.split_data(xr, **kw)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="evenly"):
        utils.split_data(x, 3)
    parts = utils.split_and_load(x.asnumpy(), [cpu(0), cpu(1)])
    assert [p.context for p in parts] == [cpu(0), cpu(1)]
    np.testing.assert_array_equal(parts[1].asnumpy(), x.asnumpy()[5:])


def test_clip_global_norm_and_files(tmp_path):
    r = np.random.default_rng(6)
    vals = [r.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    got = [tmx.nd.array(v, ctx=cpu()) for v in vals]
    want = [mx.nd.array(v) for v in vals]
    ng = tmx.gluon.utils.clip_global_norm(got, 1.5)
    nw = mx.gluon.utils.clip_global_norm(want, 1.5)
    assert abs(ng - nw) <= 1e-6 * nw
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6)
    total = tmx.gluon.utils.clip_global_norm(got, 100.0,
                                             check_isfinite=False)
    assert isinstance(total, tmx.nd.NDArray)
    f = tmp_path / "blob"
    f.write_bytes(b"gluon" * 1000)
    digest = hashlib.sha1(b"gluon" * 1000).hexdigest()
    assert tmx.gluon.utils.check_sha1(str(f), digest)
    assert not tmx.gluon.utils.check_sha1(str(f), "0" * 40)
    with pytest.raises(RuntimeError, match="network"):
        tmx.gluon.utils.download("http://example.invalid/x")
