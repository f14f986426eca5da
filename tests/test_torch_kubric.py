"""The port's Kubric MOVi-f reader and what it stands on, against OpenCV and
the JAX package's reader on the CPU (no JAX model is compiled):

  * `datasets.png.read_png` against cv2.imread(IMREAD_COLOR) bit for bit:
    files written by cv2 at several compression levels and filter flags,
    by write_png with each filter forced and mixed by row, greyscale, RGBA,
    palette and greyscale-alpha files; what it does not handle raises;
  * `datasets.image_ops`: RGB -> HSV and the truncating HSV -> RGB on all
    2^24 codes, the Gaussian blur and the float32 resize against OpenCV;
  * `datasets.kubric.KubricMovifDataset` against JAX's on one cv2-written
    tree (as tests/test_datasets.py writes it, 128 wide: a multiple of 64,
    so that cv2.cvtColor's HSV -> RGB takes its vector loop on every pixel
    on any SIMD width): samples bit for bit without augmentations and with
    them (frames within OpenCV's float resize of JAX's), the Generators in
    the same state after the reads, and a failed sample where JAX raises;
  * the training collation against JAX's.

OpenCV and the JAX package are imported by the tests that compare with
them (`_cv2`, `_jax`), which skip where they are missing; the write_png ->
read_png round trips and the raises run without either.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from cotracker_tpu_torch.datasets import kubric as PK
from cotracker_tpu_torch.datasets.image_ops import (
    gaussian_blur_u8, gaussian_kernel_u8, resize_linear, rgb_to_hsv_u8,
)
from cotracker_tpu_torch.datasets.png import read_png, read_pngs, write_png
from cotracker_tpu_torch.datasets.utils import collate_fn_train
from cotracker_tpu_torch.training.data_loader import collate_batch
from cotracker_tpu_torch.utils.visualizer import hsv_to_rgb

torch.set_num_threads(2)


def _cv2():
    return pytest.importorskip("cv2")


def _jax():
    """The JAX package's reader, its collate_fn_train and its loader's
    collate_batch."""
    jax_datasets = pytest.importorskip("cotracker_tpu.datasets")
    from cotracker_tpu.datasets import kubric
    from cotracker_tpu.datasets.utils import collate_fn_train as jax_collate_fn_train
    from cotracker_tpu.training.data_loader import collate_batch as jax_collate_batch

    assert jax_datasets.kubric is kubric
    return kubric, jax_collate_fn_train, jax_collate_batch

# ------------------------------------------------------------------ PNG


def _smooth(H, W, C=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    t = torch.nn.functional.interpolate(torch.rand(1, C, H // 8 + 2, W // 8 + 2, generator=g),
                                        size=(H, W), mode="bicubic")[0].clamp(0, 1) * 255
    return t.permute(1, 2, 0).numpy().astype(np.uint8)


IMAGES = {
    "noise": (np.random.default_rng(0).random((37, 53, 3)) * 255).astype(np.uint8),
    "smooth": _smooth(61, 45),
}


def _cv2_rgb(path):
    cv2 = _cv2()
    return cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]


def _check(path, want=None, opencv=True):
    """read_png(path) equals `want` where given, and cv2.imread's RGB where
    `opencv` (the test then skips without cv2)."""
    out = read_png(path)
    if want is not None:
        np.testing.assert_array_equal(out, want)
    if opencv:
        np.testing.assert_array_equal(out, _cv2_rgb(path))


def test_read_png_equals_opencv_on_cv2_and_pil_files(tmp_path):
    """cv2 at compression levels 0, 1, 6 and 9, with each filter flag and
    its default, on noise and on a smooth image; greyscale and RGBA by cv2;
    palette and greyscale + alpha by PIL (cv2 writes neither); cv2's
    16-bit file raises."""
    cv2 = _cv2()
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, IMAGES["smooth"].astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(deep)
    for kind, img in IMAGES.items():
        for level in (0, 1, 6, 9):
            for flag in ("IMWRITE_PNG_FILTER_SUB", "IMWRITE_PNG_FILTER_UP",
                         "IMWRITE_PNG_FILTER_AVG", "IMWRITE_PNG_FILTER_PAETH",
                         "IMWRITE_PNG_ALL_FILTERS", None):
                path = str(tmp_path / f"{kind}{level}{flag}.png")
                params = [cv2.IMWRITE_PNG_COMPRESSION, level]
                if flag:
                    params += [cv2.IMWRITE_PNG_FILTER, getattr(cv2, flag)]
                cv2.imwrite(path, img[..., ::-1], params)
                _check(path, img)
    img = IMAGES["smooth"]
    for name, arr in (("grey", img[..., 0]), ("rgba", np.concatenate([img, img[..., :1]], -1))):
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, arr)
        _check(path)
    Image = pytest.importorskip("PIL.Image")
    for mode in ("P", "LA"):
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(img).convert(mode).save(path)
        _check(path)


def _write_png_cases(tmp_path):
    """write_png with each filter forced, the heuristic's mix and the five
    in turn by row, in RGB, greyscale and RGBA: yields each file's path and
    the RGB image read_png should give (greyscale on three channels, the
    alpha dropped)."""
    for filters in (0, 1, 2, 3, 4, None, "by_row"):
        for kind, img in IMAGES.items():
            f = np.arange(img.shape[0]) % 5 if filters == "by_row" else filters
            path = str(tmp_path / f"{kind}.png")
            grey, rgba = img[..., 0], np.concatenate([img, img[..., :1]], -1)
            for chans, want in ((img, img), (grey, np.repeat(img[..., :1], 3, -1)), (rgba, img)):
                write_png(path, chans, filters=f)
                yield path, want


def test_write_png_round_trips(tmp_path):
    """read_png gives back what write_png wrote, for every filter and colour
    type it writes; files of two sizes decoded together by read_pngs, the
    same as one by one (no OpenCV needed)."""
    for path, want in _write_png_cases(tmp_path):
        _check(path, want, opencv=False)
    paths, want = [], []
    for i in range(6):
        img = _smooth(24 + 8 * (i % 2), 40, seed=i)
        path = str(tmp_path / f"{i}.png")
        write_png(path, img, filters=None if i % 3 else (np.arange(img.shape[0]) + i) % 5)
        paths.append(path)
        want.append(img)
    for out, img in zip(read_pngs(paths), want):
        np.testing.assert_array_equal(out, img)


def test_read_png_equals_opencv_on_write_png_files(tmp_path):
    """write_png's files (every filter, RGB, greyscale and RGBA) read as
    cv2.imread reads them."""
    _cv2()
    for path, want in _write_png_cases(tmp_path):
        _check(path, want)


def _rewrite_header(src, dst, **fields):
    """Copy a PNG file with IHDR fields changed (its CRC made good)."""
    data = open(src, "rb").read()
    W, H, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(W=W, H=H, depth=depth, ctype=ctype, comp=comp, filt=filt, interlace=interlace)
    vals.update(fields)
    ihdr = struct.pack(">IIBBBBB", *vals.values())
    chunk = b"IHDR" + ihdr
    open(dst, "wb").write(data[:12] + chunk + struct.pack(">I", zlib.crc32(chunk)) + data[33:])


def test_read_png_raises_on_what_it_does_not_handle(tmp_path):
    """A 16-bit file (its header rewritten), an interlaced one, a palette
    file without PLTE and a chunk whose CRC does not match raise a
    ValueError naming the property."""
    img = IMAGES["smooth"]
    src = str(tmp_path / "src.png")
    write_png(src, img)
    deep = str(tmp_path / "deep.png")
    _rewrite_header(src, deep, depth=16)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(deep)
    _rewrite_header(src, deep, ctype=3)
    with pytest.raises(ValueError, match="without a PLTE chunk"):
        read_png(deep)
    laced = str(tmp_path / "laced.png")
    _rewrite_header(src, laced, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        read_png(laced)
    data = bytearray(open(src, "rb").read())
    data[50] ^= 0xFF  # inside IDAT's payload
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC of its IDAT chunk"):
        read_png(bad)


# ------------------------------------------------------------ image ops


def _all_codes(chunk):
    c = np.arange(chunk << 20, (chunk + 1) << 20, dtype=np.uint32)
    return np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)


def test_hsv_conversions_are_opencvs_on_every_code():
    """RGB -> HSV, and HSV -> RGB truncated (1024 pixels a row: cvtColor's
    vector loop on every pixel), on all 2^24 codes."""
    cv2 = _cv2()
    for k in range(16):
        codes = _all_codes(k).reshape(1024, 1024, 3)
        np.testing.assert_array_equal(rgb_to_hsv_u8(codes),
                                      cv2.cvtColor(codes, cv2.COLOR_RGB2HSV))
        np.testing.assert_array_equal(hsv_to_rgb(codes, truncate=True),
                                      cv2.cvtColor(codes, cv2.COLOR_HSV2RGB))


def test_blur_and_resize_are_opencvs():
    """The blur at three sigmas in [0.1, 2.0] and odd sizes: OpenCV's 8-bit
    path is integer arithmetic, which the port repeats, so equal at every
    pixel. The float32 resize up and down: within 1e-3."""
    cv2 = _cv2()
    rng = np.random.default_rng(2)
    for sigma in (0.1, 0.77, 2.0):
        taps = gaussian_kernel_u8(11, sigma)
        assert taps.sum() == 256 and (taps == taps[::-1]).all()
        for H, W in ((37, 53), (64, 96), (5, 3), (1, 1)):
            img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
            ref = cv2.GaussianBlur(img, (11, 11), sigma)
            assert np.abs(gaussian_blur_u8(img, 11, sigma).astype(int) - ref).max() == 0
    for out_hw in ((80, 120), (700, 650), (40, 50), (33, 48), (131, 17)):
        H, W = (512, 512) if out_hw[0] > 200 else (64, 96)
        img = (rng.random((H, W, 3)) * 255).astype(np.float32)
        ref = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
        out = resize_linear(img, out_hw)
        assert out.dtype == np.float32 and out.shape == ref.shape
        assert np.abs(out - ref).max() <= 1e-3


# ------------------------------------------------------------- the reader

T_SEQ, H_SEQ, W_SEQ, N_TRACKS = 30, 64, 128, 256
CROP = (48, 64)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """As tests/test_datasets.py::_make_kubric_dir writes one (cv2 frames of
    noise, tracks uniform in the frame, 10% occluded), three sequences."""
    cv2 = _cv2()
    root = tmp_path_factory.mktemp("kubric")
    rng = np.random.default_rng(0)
    for s in range(3):
        name = f"seq{s:03d}"
        d = os.path.join(root, name, "frames")
        os.makedirs(d)
        for t in range(T_SEQ):
            img = (rng.random((H_SEQ, W_SEQ, 3)) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"{t:03d}.png"), img)
        coords = (rng.random((N_TRACKS, T_SEQ, 2)) * [W_SEQ - 1, H_SEQ - 1]).astype(np.float32)
        occluded = rng.random((N_TRACKS, T_SEQ)) > 0.9
        np.save(os.path.join(root, name, name + ".npy"),
                {"coords": coords, "visibility": occluded}, allow_pickle=True)
    return str(root)


def _pair(tree, augs_prob=None, **kw):
    kw = {**dict(crop_size=CROP, seq_len=12, traj_per_sample=16, seed=3), **kw}
    j, p = _jax()[0].KubricMovifDataset(tree, **kw), PK.KubricMovifDataset(tree, **kw)
    if augs_prob is not None:
        for ds in (j, p):
            ds.blur_aug_prob = ds.color_aug_prob = augs_prob
    return j, p


def _same_sample(sj, sp, frame_tol):
    for f in ("trajectory", "visibility", "valid"):
        np.testing.assert_array_equal(getattr(sp, f), getattr(sj, f), err_msg=f)
    assert sp.video.shape == sj.video.shape and sp.video.dtype == sj.video.dtype
    assert np.abs(sp.video - sj.video).max() <= frame_tol


SCHEDULES = {
    "fixed": {},
    "random_seq_len": dict(random_seq_len=True),
    "random_number_traj": dict(random_number_traj=True, seq_len=24),
    "too_few_tracks": dict(traj_per_sample=600),
    "vis_last_frame": dict(sample_vis_last_frame=True),
}


def test_reads_are_jaxs(tree):
    """Reads in a row from the datasets' own Generators, for each schedule
    without augmentations (six reads: samples and gotit bit for bit) and,
    for two, with them, colour jitter and blur forced on every read (1.0)
    or never (0.0) (four reads: tracks and visibility bit for bit, frames
    within the float32 resize's 1e-3 of JAX's, every other step bit for
    bit); the Generators in the same state after the reads."""
    for schedule, kw in SCHEDULES.items():
        j, p = _pair(tree, use_augs=False, **kw)
        for i in range(6):
            (sj, gj), (sp, gp) = j[i % 3], p[i % 3]
            assert gp == gj, schedule
            _same_sample(sj, sp, 0.0)
            if schedule == "too_few_tracks":
                assert not gp and not sp.video.any()
        assert p.rng.bit_generator.state == j.rng.bit_generator.state, schedule
    for schedule in ("fixed", "random_seq_len"):
        for augs_prob in (1.0, 0.0):
            j, p = _pair(tree, augs_prob=augs_prob, use_augs=True, **SCHEDULES[schedule])
            for i in range(4):
                (sj, gj), (sp, gp) = j[i % 3], p[i % 3]
                assert gp == gj, (schedule, augs_prob)
                _same_sample(sj, sp, 1e-3)
            assert p.rng.bit_generator.state == j.rng.bit_generator.state


# schedules where some draws leave the clip too few frames: JAX's reader
# raises an IndexError there
SHORT_CLIPS = {
    # the online trainer's: a random length and frame rate
    "online": dict(random_seq_len=True, random_frame_rate=True),
    # a random track count at seq_len 12 draws lengths of 0 to 16 frames
    "number_traj": dict(random_number_traj=True),
}


def test_reads_where_jax_raises(tree):
    """One read a seed, for both schedules with and without augmentations:
    where JAX's reader returns, the port's `get(index, rng)` reads its
    sample and leaves the Generator where JAX's is; where a draw leaves too
    few frames, JAX raises an IndexError and the port's sample fails
    (gotit False), zeroed."""
    for schedule, kw in SHORT_CLIPS.items():
        for use_augs in (False, True):
            j, p = _pair(tree, use_augs=use_augs, **kw)
            read = failed = 0
            for s in range(16):
                j.rng, rng = np.random.default_rng(s), np.random.default_rng(s)
                sp, ok = p.get(s % 3, rng)
                try:
                    sj, gj = j[s % 3]
                except IndexError:
                    failed += 1
                    assert not ok and not sp.video.any() and sp.video.shape == (12, 3, *CROP)
                    continue
                read += 1
                assert ok == gj
                _same_sample(sj, sp, 1e-3 if use_augs else 0.0)
                assert rng.bit_generator.state == j.rng.bit_generator.state
            assert read and failed, (schedule, use_augs)


def test_photometric_augs_with_replace_are_jaxs(tree):
    """The base class's photometric pipeline with the replace step (two
    nested colour jitters a frame for the alternates, drawn before the
    replace loop), every step forced: frames, tracks and visibility bit for
    bit, the Generators in step."""
    rng = np.random.default_rng(5)
    frames = [(rng.random((H_SEQ, W_SEQ, 3)) * 255).astype(np.uint8) for _ in range(6)]
    trajs = rng.random((6, 40, 2)) * [W_SEQ - 1, H_SEQ - 1]
    vis = np.ones((6, 40), bool)
    j, p = _pair(tree, augs_prob=1.0)
    j.replace_aug_prob = p.replace_aug_prob = 1.0
    j.rng, g = np.random.default_rng(7), np.random.default_rng(7)
    rj, tj, vj = j.add_photometric_augs([f.copy() for f in frames], trajs.copy(), vis.copy())
    rp, tp, vp = p.add_photometric_augs(g, [f.copy() for f in frames], trajs.copy(), vis.copy())
    for a, b in zip(rp, rj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tp, tj)
    np.testing.assert_array_equal(vp, vj)
    assert g.bit_generator.state == j.rng.bit_generator.state


def test_collation_is_jaxs(tree):
    """collate_fn_train of (sample, gotit) pairs, and the loader's
    collate_batch of port samples against JAX's of JAX samples, at a fixed
    seq_len: bit for bit."""
    _, jax_collate_fn_train, jax_collate_batch = _jax()
    j, p = _pair(tree, use_augs=False)
    pairs_j, pairs_p = [j[0], j[1]], [p[0], p[1]]
    bj, gj = jax_collate_fn_train(pairs_j)
    bp, gp = collate_fn_train(pairs_p)
    assert gp == gj and bp.seq_name == bj.seq_name
    for f in ("video", "trajectory", "visibility", "valid"):
        np.testing.assert_array_equal(getattr(bp, f), getattr(bj, f))
    rng = np.random.default_rng(3)
    p.rng = rng
    samples_p = [p.get(i, rng)[0] for i in range(2)]
    j.rng = np.random.default_rng(3)
    samples_j = [j[i][0] for i in range(2)]
    cj, cp = jax_collate_batch(samples_j), collate_batch(samples_p)
    assert sorted(cp) == sorted(cj)
    for k in cj:
        assert cp[k].dtype == cj[k].dtype
        np.testing.assert_array_equal(cp[k], cj[k])
