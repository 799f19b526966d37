"""Port parity: the image package and image IO
(``mmlspark_tpu_torch/image/``, ``io/binary.py``, ``io/image_io.py``)
against the JAX package's, on seeded uint8 images on the CPU.

The JAX package runs its image ops through OpenCV (cv2, installed on this
machine; PIL when cv2 is missing), the port through numpy and its one
torch resize. Tolerances:

* ``resize`` (the port's ``resize_uint8``, bilinear over half-pixel
  centres in float64, against ``cv2.resize``'s 11-bit fixed point): at
  most **1 uint8 level** per pixel, and at most a fifth of the pixels off
  at all;
* ``blur`` over an even box (OpenCV averages a power-of-two box by halves,
  rounding each): at most 1 level; every other op (crop, centre crop,
  flip, threshold, colour formats, ``gaussiankernel``, odd boxes) bitwise;
* float tensors built from bitwise-equal pixels: within 1e-6 (float32
  rounding of the same scale/mean/std steps).

Decoding and encoding go through the same library in both packages here,
so decoded pixels are held bitwise.
"""

import os
import sys
import zipfile

import numpy as np
import pytest
import torch

import mmlspark_tpu.image as J
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.core.dataframe import object_col as jobject_col
from mmlspark_tpu.image import transforms as jtransforms
from mmlspark_tpu.image import unroll as junroll
from mmlspark_tpu.io import read_binary_files as jread_binary
from mmlspark_tpu.io import read_images as jread_images
import mmlspark_tpu_torch.image as P
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.core.dataframe import object_col
from mmlspark_tpu_torch.core.residency import (configure_residency,
                                               get_residency_manager,
                                               residency_stats)
from mmlspark_tpu_torch.image import schema as pschema
from mmlspark_tpu_torch.image import transforms as ptransforms
from mmlspark_tpu_torch.image import unroll as punroll
from mmlspark_tpu_torch.io import read_binary_files, read_images
from mmlspark_tpu_torch.models.runner import StagingSlabPool
from mmlspark_tpu_torch.observability import reset_all

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

TENSOR = dict(rtol=0, atol=1e-6)
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


@pytest.fixture(autouse=True)
def _clean_slate():
    get_residency_manager().spill_all()
    configure_residency(0)
    reset_all()


def _noise(h, w, c=3, seed=0):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                               dtype=np.uint8)
    return img[:, :, 0] if c == 0 else img


def _frames(cells):
    return (JDataFrame({"image": jobject_col(cells)}),
            DataFrame({"image": object_col(cells)}))


def _levels(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


# ---------------------------------------------------------------------------
# the one resize


@pytest.mark.parametrize("src,dst,c", [
    ((256, 256), (224, 224), 3), ((240, 320), (224, 224), 3),
    ((32, 48), (16, 24), 3), ((8, 8), (32, 32), 3), ((50, 40), (32, 32), 1),
    ((33, 17), (20, 41), 4), ((64, 64), (32, 32), 3)])
def test_resize_within_one_level_of_jax_resize(src, dst, c):
    img = _noise(*src, c=c, seed=sum(src))
    want = junroll._resize(img, *dst)
    got = punroll._resize(img, *dst)
    d = _levels(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 0.2


def test_resize_batch_equals_one_at_a_time_and_keeps_same_size():
    imgs = np.stack([_noise(30, 20, seed=i) for i in range(5)])
    batch = P.resize_uint8(torch.from_numpy(imgs), 16, 24).numpy()
    for i in range(5):
        np.testing.assert_array_equal(batch[i],
                                      punroll._resize(imgs[i], 16, 24))
    same = torch.from_numpy(imgs)
    assert P.resize_uint8(same, 30, 20) is same
    with pytest.raises(TypeError, match="uint8"):
        P.resize_uint8(same.float(), 8, 8)


# ---------------------------------------------------------------------------
# the stage ops


_OP_CASES = [
    ("crop", dict(x=3, y=2, height=10, width=12)),
    ("centercrop", dict(height=10, width=12)),
    ("flip", dict(flipCode=0)), ("flip", dict(flipCode=1)),
    ("flip", dict(flipCode=-1)),
    ("blur", dict(height=3, width=5)), ("blur", dict(height=1, width=7)),
    ("threshold", dict(threshold=127.5, maxVal=200.4, type=0)),
    ("threshold", dict(threshold=100, maxVal=255, type=1)),
    ("threshold", dict(threshold=100.7, maxVal=255, type=2)),
    ("threshold", dict(threshold=100, maxVal=255, type=3)),
    ("threshold", dict(threshold=100, maxVal=255, type=4)),
    ("gaussiankernel", dict(apertureSize=5, sigma=1.5)),
    ("gaussiankernel", dict(apertureSize=3, sigma=0)),
    ("gaussiankernel", dict(apertureSize=9, sigma=-1)),
    ("gaussiankernel", dict(apertureSize=11, sigma=0)),
] + [("colorformat", dict(format=code)) for code in range(12)]


@pytest.mark.parametrize("action,params", _OP_CASES)
@pytest.mark.parametrize("c", [1, 3, 4])
def test_stage_op_equals_jax_bitwise(action, params, c):
    img = _noise(23, 31, c=c, seed=c)
    p = dict(params, action=action)
    try:
        want = jtransforms._OPS[action](img, p)
    except Exception:
        with pytest.raises(ValueError):
            ptransforms._OPS[action](img, p)
        return
    got = ptransforms._OPS[action](img, p)
    np.testing.assert_array_equal(got, np.asarray(want).reshape(got.shape))


@pytest.mark.parametrize("params", [dict(height=4, width=2),
                                    dict(height=2, width=2),
                                    dict(height=4, width=4)])
def test_even_box_blur_within_one_level(params):
    img = _noise(23, 31, seed=5)
    p = dict(params, action="blur")
    assert _levels(ptransforms._OPS["blur"](img, p),
                   jtransforms._OPS["blur"](img, p)).max() <= 1


def test_unsupported_codes_raise():
    img = _noise(4, 4)
    with pytest.raises(ValueError, match="code 40"):
        ptransforms._apply_colorformat(img, {"format": 40})
    with pytest.raises(ValueError, match="threshold type"):
        ptransforms._apply_threshold(img, {"threshold": 1, "maxVal": 2,
                                           "type": 9})
    with pytest.raises(ValueError, match="unsupported transformation"):
        P.ImageTransformer(stages=[{"action": "warp"}]).transform(
            DataFrame({"image": object_col([P.make_image(img)])}))


def test_image_transformer_structs_and_tensors_equal_jax():
    cells = [J.make_image(_noise(20, 26, seed=i), origin=f"o{i}")
             for i in range(3)] + [None, _noise(20, 26, seed=9)]
    jdf, pdf = _frames(cells)
    stages = [J.CropImage(x=1, y=2, height=14, width=20), J.Flip(1),
              J.Blur(3, 3), J.Threshold(60, 250, 3)]
    want = J.ImageTransformer(stages=stages).transform(jdf)["image"]
    got = P.ImageTransformer(stages=stages).transform(pdf)["image"]
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert {k: v for k, v in g.items() if k != "data"} == \
            {k: v for k, v in w.items() if k != "data"}
        np.testing.assert_array_equal(g["data"], w["data"])
    kw = dict(to_tensor=True, normalize_mean=MEAN, normalize_std=STD)
    jt = J.ImageTransformer(**kw).center_crop(12, 12).flip(0)
    pt = P.ImageTransformer(**kw).center_crop(12, 12).flip(0)
    for g, w in zip(pt.transform(pdf)["image"], jt.transform(jdf)["image"]):
        if w is None:
            assert g is None
            continue
        assert g.shape == (3, 12, 12) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TENSOR)


def test_image_transformer_resize_and_save_load(tmp_path):
    cells = [J.make_image(_noise(32, 48, seed=i)) for i in range(2)]
    jdf, pdf = _frames(cells)
    stages = [J.ResizeImage(size=16, keep_aspect_ratio=True), J.Flip(1)]
    want = J.ImageTransformer(stages=stages).transform(jdf)["image"]
    t = P.ImageTransformer(stages=stages)
    got = t.transform(pdf)["image"]
    for g, w in zip(got, want):
        assert (g["height"], g["width"]) == (w["height"], w["width"]) \
            == (16, 24)
        assert _levels(g["data"], w["data"]).max() <= 1
    t.save(str(tmp_path / "it"))
    back = P.ImageTransformer.load(str(tmp_path / "it")).transform(pdf)
    for g, b in zip(got, back["image"]):
        np.testing.assert_array_equal(g["data"], b["data"])


# ---------------------------------------------------------------------------
# the device path: normalize_program and transform_resident


def test_normalize_program_equals_jax():
    x = np.stack([_noise(9, 7, seed=i) for i in range(4)])
    key = (1 / 255., tuple(MEAN), tuple(STD), 3)
    want = np.asarray(jtransforms.normalize_program(*key)(x))
    got = ptransforms.normalize_program(*key, True, "cpu")(
        torch.from_numpy(x))
    assert got.shape == (4, 3, 9, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TENSOR)


def _tensor_transformer(pkg):
    return pkg.ImageTransformer(
        to_tensor=True, normalize_mean=MEAN,
        normalize_std=STD).center_crop(height=16, width=16)


def test_transform_resident_one_ingest_of_uint8_bytes_and_parity():
    """ONE counted ingest of N·H·W·C uint8 bytes (a quarter of the float32
    tensor's), normalization on the device, the output a device-born
    column equal to the host tensor path and to the JAX package's."""
    cells = [J.make_image(_noise(24, 32, seed=i)) for i in range(4)]
    jdf, pdf = _frames(cells)
    t = _tensor_transformer(P)
    reset_all()
    out = t.transform_resident(pdf, device="cpu")
    s = residency_stats()
    assert s["h2d_ops"]["ingest"] == 1
    assert s["h2d_bytes"]["ingest"] == 4 * 16 * 16 * 3
    assert s["d2h_ops"]["materialize"] == 0
    assert out.is_resident("image")
    dev = out.device_column("image").device_array()
    assert dev.shape == (4, 3, 16, 16) and dev.dtype == torch.float32
    host = t.transform(pdf)["image"]
    ref = _tensor_transformer(J).transform_resident(jdf)["image"]
    got = [np.asarray(out["image"][i]) for i in range(4)]
    assert residency_stats()["d2h_ops"]["materialize"] >= 1
    for g, h, r in zip(got, host, ref):
        np.testing.assert_allclose(g, h, **TENSOR)
        np.testing.assert_allclose(g, np.asarray(r), **TENSOR)


def test_transform_resident_slab_reuse_and_refusals():
    pool = StagingSlabPool(pin=False)
    _, pdf = _frames([J.make_image(_noise(20, 20, seed=i)) for i in range(3)])
    t = _tensor_transformer(P)
    a = t.transform_resident(pdf, slab_pool=pool, device="cpu")
    b = t.transform_resident(pdf, slab_pool=pool, device="cpu")
    assert pool.allocs == 1 and pool.reuses == 1
    np.testing.assert_array_equal(np.asarray(a["image"][0]),
                                  np.asarray(b["image"][0]))
    _, ragged = _frames([J.make_image(_noise(16, 16)),
                         J.make_image(_noise(16, 24))])
    with pytest.raises(ValueError, match="uniform"):
        P.ImageTransformer(to_tensor=True).transform_resident(ragged,
                                                              device="cpu")
    _, holes = _frames([J.make_image(_noise(16, 16)), None])
    with pytest.raises(ValueError, match="null"):
        P.ImageTransformer().transform_resident(holes, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.transform_resident(pdf)


# ---------------------------------------------------------------------------
# codecs, unroll, augment, readers


def test_codecs_equal_jax_and_undecodable_is_none():
    img = J.make_image(_noise(12, 10, seed=3))
    raw = J.encode_image(img, ".png")
    assert P.encode_image(img, ".png") == raw
    got, want = P.decode_image(raw, origin="x"), J.decode_image(raw, "x")
    assert {k: v for k, v in got.items() if k != "data"} == \
        {k: v for k, v in want.items() if k != "data"}
    np.testing.assert_array_equal(got["data"], want["data"])
    assert P.decode_image(b"garbage bytes") is None


def test_no_decoder_raises_import_error_naming_both(monkeypatch):
    """Without cv2 and PIL every row would decode to None (the JAX
    package's ``except Exception``) and drop silently: the port raises."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        pschema.decode_image(b"garbage bytes")
    with pytest.raises(ImportError, match="cv2.*PIL"):
        P.ImageTransformer().transform(
            DataFrame({"image": object_col([b"garbage bytes"])}))


def test_pil_decoder_without_cv2(monkeypatch):
    img = P.make_image(_noise(6, 5, seed=2))
    raw = P.encode_image(img, ".png")
    monkeypatch.setitem(sys.modules, "cv2", None)
    back = pschema.decode_image(raw, origin="o")
    np.testing.assert_array_equal(back["data"], img["data"])
    assert back["origin"] == "o" and pschema.decode_image(b"junk") is None


def test_tensor_helpers_equal_jax():
    imgs = [J.make_image(_noise(5, 6, c, seed=c)) for c in (3, 3)]
    for fn in ("to_nhwc_tensor", "to_nchw_tensor"):
        for kw in ({}, {"scale": 1 / 255., "mean": MEAN, "std": STD,
                        "bgr_to_rgb": True}):
            np.testing.assert_array_equal(getattr(P, fn)(imgs, **kw),
                                          getattr(J, fn)(imgs, **kw))


def test_unroll_roll_and_stages_equal_jax():
    img = J.make_image(_noise(4, 5))
    v = punroll.unroll(img)
    np.testing.assert_array_equal(v, junroll.unroll(img))
    np.testing.assert_array_equal(punroll.roll(v, img)["data"], img["data"])
    jdf, pdf = _frames([J.make_image(_noise(8, 8, seed=i)) for i in range(2)]
                       + [None])
    for j, p in zip(J.UnrollImage().transform(jdf)["<image>"],
                    P.UnrollImage().transform(pdf)["<image>"]):
        assert (j is None and p is None) or np.array_equal(j, p)
    raw = [J.encode_image(J.make_image(_noise(16, 12, seed=i)))
           for i in range(2)] + [None, b"junk"]
    jdf, pdf = _frames(raw)
    for j, p in zip(J.UnrollBinaryImage(height=8, width=10)
                    .transform(jdf)["<image>"],
                    P.UnrollBinaryImage(height=8, width=10)
                    .transform(pdf)["<image>"]):
        assert (j is None) == (p is None)
        if j is not None:
            assert _levels(p, j).max() <= 1
    for j, p in zip(J.ResizeImageTransformer(height=8, width=6)
                    .transform(jdf)["image"],
                    P.ResizeImageTransformer(height=8, width=6)
                    .transform(pdf)["image"]):
        assert (j is None) == (p is None)
        if j is not None:
            assert _levels(p["data"], j["data"]).max() <= 1


def test_image_set_augmenter_equals_jax():
    jdf, pdf = _frames([J.make_image(_noise(6, 7, seed=i)) for i in range(2)])
    want = J.ImageSetAugmenter(flip_left_right=True,
                               flip_up_down=True).transform(jdf)["image"]
    got = P.ImageSetAugmenter(flip_left_right=True,
                              flip_up_down=True).transform(pdf)["image"]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["data"], w["data"])


def test_binary_and_image_readers_equal_jax(tmp_path):
    d = tmp_path / "files"
    os.makedirs(d)
    for i in range(3):
        with open(d / f"img{i}.png", "wb") as f:
            f.write(J.encode_image(J.make_image(_noise(8, 9, seed=i))))
    with open(d / "junk.txt", "wb") as f:
        f.write(b"not an image")
    with zipfile.ZipFile(d / "pack.zip", "w") as zf:
        zf.writestr("inner.bin", b"\x01\x02")
    for kw in ({}, {"pattern": "*.png"}, {"sample_ratio": 0.5, "seed": 3}):
        want, got = jread_binary(str(d), **kw), read_binary_files(str(d), **kw)
        assert list(got["path"]) == list(want["path"])
        assert list(got["bytes"]) == list(want["bytes"])
    for drop in (True, False):
        want = jread_images(str(d), drop_failures=drop)
        got = read_images(str(d), drop_failures=drop)
        assert list(got["path"]) == list(want["path"])
        for g, w in zip(got["image"], want["image"]):
            assert (g is None) == (w is None)
            if w is not None:
                assert g["origin"] == w["origin"]
                np.testing.assert_array_equal(g["data"], w["data"])
