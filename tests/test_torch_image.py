"""The port's ``image`` module (mxnet_tpu_torch) against the reference's
(mxnet_tpu), on the CPU, on smooth JPEGs of 50-70 px:

- ``imdecode`` (colour, BGR, grey), ``imread``, ``imresize`` at every
  interpolation, ``scale_down``, ``resize_short``, ``fixed_crop``,
  ``random_crop``, ``center_crop``, ``color_normalize`` and
  ``random_size_crop``, exactly;
- each of the 18 augmenter classes, and ``CreateAugmenter`` with
  ``rand_crop``, ``rand_resize``, ``rand_mirror``, the colour jitters,
  ``hue``, ``pca_noise``, ``rand_gray``, ``mean=True`` and ``std=True``,
  under the same ``random.seed``/``np.random.seed``: exact, but for the
  float jitters (within 1e-6), and from an explicit ``rng`` as from the
  seeded global generators;
- ``ImageIter`` over a ``.rec`` (shuffled, ``num_parts``) and over an
  ``imglist`` under ``path_root``, every batch exactly the reference's;
- per-image results (``imdecode``, the functions, the augmenters) are
  NDArrays on ``cpu()`` whatever the current context; ``ImageIter`` puts
  only its batch on its ``ctx``.
"""
import random

import cv2
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

JITTER_TOL = 1e-6


def _photo(seed, h=54, w=66):
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx, ph = r.uniform(0.02, 0.12, 3)
        img[..., c] = 128 + 80 * np.sin(fy * y + fx * x + 6 * ph)
    img[h // 4:h // 2, w // 3:w // 2] = r.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg(seed, h=54, w=66):
    ok, buf = cv2.imencode(".jpg", _photo(seed, h, w),
                           [int(cv2.IMWRITE_JPEG_QUALITY), 95])
    assert ok
    return buf.tobytes()


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _on_cpu(a):
    assert isinstance(a, tmx.NDArray) and a.context.device_type == "cpu"


def _same(got, want, tol=0.0):
    _on_cpu(got)
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape,
                                                       g.dtype, w.dtype)
    if tol:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(g, w)


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_and_imread_match(tmp_path, flag, to_rgb):
    buf = _jpeg(1)
    _same(tmx.image.imdecode(buf, flag, to_rgb),
          mx.image.imdecode(buf, flag, to_rgb))
    _same(tmx.image.imdecode(np.frombuffer(buf, np.uint8), flag, to_rgb),
          mx.image.imdecode(buf, flag, to_rgb))
    path = tmp_path / "a.jpg"
    path.write_bytes(buf)
    _same(tmx.image.imread(str(path), flag, to_rgb),
          mx.image.imread(str(path), flag, to_rgb))
    with pytest.raises(tmx.MXNetError):
        tmx.image.imdecode(b"not an image")


def test_geometric_functions_match():
    img = _photo(2)
    src_t, src_m = tmx.nd.array(img, tmx.cpu()), mx.nd.array(img,
                                                               dtype=np.uint8)
    for interp in range(5):
        _same(tmx.image.imresize(src_t, 40, 30, interp),
              mx.image.imresize(src_m, 40, 30, interp))
    for size in ((30, 40), (80, 20), (100, 100)):
        assert tmx.image.scale_down((66, 54), size) == \
            mx.image.scale_down((66, 54), size)
    _same(tmx.image.resize_short(src_t, 32), mx.image.resize_short(src_m, 32))
    _same(tmx.image.fixed_crop(src_t, 3, 5, 20, 25),
          mx.image.fixed_crop(src_m, 3, 5, 20, 25))
    _same(tmx.image.fixed_crop(src_t, 3, 5, 20, 25, (16, 16), 1),
          mx.image.fixed_crop(src_m, 3, 5, 20, 25, (16, 16), 1))
    a, ra = tmx.image.center_crop(src_t, (40, 60))
    b, rb = mx.image.center_crop(src_m, (40, 60))
    _same(a, b)
    assert ra == rb
    for seed in range(4):
        a, ra = _seeded(seed, lambda: tmx.image.random_crop(src_t, (32, 24)))
        b, rb = _seeded(seed, lambda: mx.image.random_crop(src_m, (32, 24)))
        _same(a, b)
        assert ra == rb
        a, ra = _seeded(seed, lambda: tmx.image.random_size_crop(
            src_t, (24, 24), 0.3, (0.75, 1.333)))
        b, rb = _seeded(seed, lambda: mx.image.random_size_crop(
            src_m, (24, 24), 0.3, (0.75, 1.333)))
        _same(a, b)
        assert ra == rb
    a, ra = tmx.image.random_crop(src_t, (32, 24), rng=random.Random(9))
    b, rb = _seeded(9, lambda: mx.image.random_crop(src_m, (32, 24)))
    _same(a, b)
    assert ra == rb


def test_color_normalize_matches():
    arr = _photo(3).astype(np.float32)
    mean, std = np.float32([123.68, 116.28, 103.53]), \
        np.float32([58.395, 57.12, 57.375])
    _same(tmx.image.color_normalize(tmx.nd.array(arr, tmx.cpu()),
                                    tmx.nd.array(mean, tmx.cpu()),
                                    tmx.nd.array(std, tmx.cpu())),
          mx.image.color_normalize(mx.nd.array(arr), mx.nd.array(mean),
                                   mx.nd.array(std)))
    _same(tmx.image.color_normalize(arr, mean),
          mx.image.color_normalize(mx.nd.array(arr), mx.nd.array(mean)))


EIGVAL = np.array([55.46, 4.794, 1.148])
EIGVEC = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]])

# (name, factory(image module), float input, tolerance)
AUGMENTERS = [
    ("ResizeAug", lambda im: im.ResizeAug(40, 1), False, 0),
    ("ForceResizeAug", lambda im: im.ForceResizeAug((30, 20), 2), False, 0),
    ("RandomCropAug", lambda im: im.RandomCropAug((32, 24)), False, 0),
    ("RandomSizedCropAug", lambda im: im.RandomSizedCropAug(
        (24, 24), 0.08, (0.75, 1.333)), False, 0),
    ("CenterCropAug", lambda im: im.CenterCropAug((40, 30)), False, 0),
    ("BrightnessJitterAug", lambda im: im.BrightnessJitterAug(0.4), True,
     JITTER_TOL),
    ("ContrastJitterAug", lambda im: im.ContrastJitterAug(0.4), True,
     JITTER_TOL),
    ("SaturationJitterAug", lambda im: im.SaturationJitterAug(0.4), True,
     JITTER_TOL),
    ("HueJitterAug", lambda im: im.HueJitterAug(0.3), True, JITTER_TOL),
    ("ColorJitterAug", lambda im: im.ColorJitterAug(0.3, 0.3, 0.3), True,
     JITTER_TOL),
    ("LightingAug", lambda im: im.LightingAug(0.1, EIGVAL, EIGVEC), True,
     JITTER_TOL),
    ("ColorNormalizeAug", lambda im: im.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1, 57.4])),
     True, 0),
    ("RandomGrayAug", lambda im: im.RandomGrayAug(0.5), True, 0),
    ("HorizontalFlipAug", lambda im: im.HorizontalFlipAug(0.5), False, 0),
    ("CastAug", lambda im: im.CastAug(), False, 0),
    ("SequentialAug", lambda im: im.SequentialAug(
        [im.CenterCropAug((40, 40)), im.CastAug(),
         im.BrightnessJitterAug(0.2)]), False, JITTER_TOL),
    ("RandomOrderAug", lambda im: im.RandomOrderAug(
        [im.BrightnessJitterAug(0.2), im.HorizontalFlipAug(0.5),
         im.RandomGrayAug(0.5)]), True, JITTER_TOL),
]


@pytest.mark.parametrize("name,factory,as_float,tol", AUGMENTERS,
                         ids=[a[0] for a in AUGMENTERS])
def test_augmenter_matches_reference(name, factory, as_float, tol):
    img = _photo(4)
    if as_float:
        img = img.astype(np.float32)
    aug_t, aug_m = factory(tmx.image), factory(mx.image)
    assert aug_t.dumps() == aug_m.dumps()
    for seed in range(3):
        got = _seeded(seed, lambda: aug_t(tmx.nd.array(img, tmx.cpu())))
        want = _seeded(seed, lambda: aug_m(mx.nd.array(img)))
        _same(got, want, tol)


def test_augmenter_base_class():
    for pkg in (tmx, mx):
        aug = pkg.image.Augmenter(p=0.5)
        assert aug.dumps() == '["augmenter", {"p": 0.5}]'
        with pytest.raises(NotImplementedError):
            aug(None)


CREATE = [
    dict(rand_crop=True, rand_mirror=True),
    dict(resize=60, rand_crop=True, rand_resize=True, mean=True, std=True),
    dict(rand_mirror=True, brightness=0.3, contrast=0.3, saturation=0.3,
         hue=0.2, pca_noise=0.1, rand_gray=0.3, mean=True, std=True),
    dict(mean=np.array([120.0]), std=np.array([60.0, 61.0, 62.0])),
]


@pytest.mark.parametrize("kwargs", CREATE, ids=["crop_mirror", "sized",
                                                "jitters", "mean_std"])
def test_create_augmenter_chain_matches(kwargs):
    shape = (3, 40, 40)
    chain_t = tmx.image.CreateAugmenter(shape, **kwargs)
    chain_m = mx.image.CreateAugmenter(shape, **kwargs)
    assert [a.dumps() for a in chain_t] == [a.dumps() for a in chain_m]
    buf = _jpeg(5, 60, 70)

    def run(pkg, chain):
        x = pkg.image.imdecode(buf)
        for aug in chain:
            x = aug(x)
        return x

    jitter = any(k in kwargs for k in ("brightness", "pca_noise"))
    for seed in range(3):
        got = _seeded(seed, lambda: run(tmx, chain_t))
        want = _seeded(seed, lambda: run(mx, chain_m))
        _same(got, want, JITTER_TOL if jitter else 0)
        assert _np(got).shape == (40, 40, 3)
    # the same draws from explicit generators as from the seeded globals
    chain_r = tmx.image.CreateAugmenter(
        shape, rng=random.Random(1), np_rng=np.random.RandomState(1),
        **kwargs)
    _same(run(tmx, chain_r), _seeded(1, lambda: run(mx, chain_m)),
          JITTER_TOL if jitter else 0)


def _write_rec(pkg_dir, n=21):
    rec, idx = str(pkg_dir / "img.rec"), str(pkg_dir / "img.idx")
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    r = np.random.RandomState(0)
    for k in range(n):
        h, wd = r.randint(50, 71, 2)
        w.write_idx(k, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(k % 5), k, 0),
            _photo(k, h, wd)))
    w.close()
    return rec, idx


def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _assert_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("extra", [
    dict(), dict(shuffle=True, rand_crop=True, rand_mirror=True, mean=True,
                 std=True), dict(num_parts=2, part_index=1, resize=40)],
    ids=["plain", "shuffled", "part"])
def test_image_iter_over_rec_matches(tmp_path, extra):
    rec, idx = _write_rec(tmp_path)
    out = {}
    for pkg in (mx, tmx):
        c = {} if pkg is mx else {"ctx": tmx.cpu()}
        random.seed(4)
        np.random.seed(4)
        it = pkg.image.ImageIter(8, (3, 32, 32), path_imgrec=rec,
                                 path_imgidx=idx, **extra, **c)
        out[pkg] = _batches(it)
        it.reset()
        out[pkg] += _batches(it)
    _assert_batches(out[tmx], out[mx])
    assert out[tmx][-1][2] == (3 if "num_parts" not in extra else 6)


def test_image_iter_over_imglist_and_list_file_matches(tmp_path):
    names = []
    for k in range(10):
        name = "im%d.jpg" % k
        (tmp_path / name).write_bytes(_jpeg(k, 50 + k, 60))
        names.append(name)
    imglist = [[float(k % 3), n] for k, n in enumerate(names)]
    lst = tmp_path / "a.lst"
    lst.write_text("".join("%d\t%f\t%f\t%s\n" % (k, k % 3, k, n)
                           for k, n in enumerate(names)))
    for kwargs in (dict(imglist=imglist), dict(path_imglist=str(lst),
                                               label_width=2)):
        out = {}
        for pkg in (mx, tmx):
            c = {} if pkg is mx else {"ctx": tmx.cpu()}
            random.seed(2)
            it = pkg.image.ImageIter(4, (3, 40, 40), path_root=str(tmp_path),
                                     shuffle=True, rand_crop=True, **kwargs,
                                     **c)
            out[pkg] = _batches(it)
        _assert_batches(out[tmx], out[mx])
    it = tmx.image.ImageIter(4, (3, 40, 40), imglist=imglist,
                             path_root=str(tmp_path), shuffle=True,
                             rng=random.Random(2), ctx=tmx.cpu())
    random.seed(2)
    ref = mx.image.ImageIter(4, (3, 40, 40), imglist=imglist,
                             path_root=str(tmp_path), shuffle=True)
    _assert_batches(_batches(it), _batches(ref))


def test_per_image_results_stay_on_the_cpu(tmp_path, monkeypatch):
    """The default context is ``gpu(0)``; decoding and augmenting still
    give ``cpu()`` arrays, and ``ImageIter`` moves only its batch."""
    assert tmx.current_context().device_type == "gpu"
    x = tmx.image.imdecode(_jpeg(6))
    _on_cpu(x)
    for aug in tmx.image.CreateAugmenter((3, 32, 32), rand_crop=True,
                                         brightness=0.2, mean=True):
        x = aug(x)
        _on_cpu(x)
    _on_cpu(tmx.image.resize_short(x, 20))
    rec, idx = _write_rec(tmp_path, n=4)
    placed, array = [], tmx.image.nd.array

    def recording(src, ctx=None, dtype=None):
        placed.append(ctx)               # then build it here, on the CPU
        return array(src, tmx.cpu(), dtype)

    monkeypatch.setattr(tmx.image.nd, "array", recording)
    it = tmx.image.ImageIter(4, (3, 32, 32), path_imgrec=rec,
                             ctx=tmx.gpu(0))
    assert next(it).data[0].shape == (4, 3, 32, 32)
    assert placed[-2:] == [tmx.gpu(0), tmx.gpu(0)]
    assert len(placed) > 2 and all(c == tmx.cpu() for c in placed[:-2])
