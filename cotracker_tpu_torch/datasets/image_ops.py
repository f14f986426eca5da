"""The three OpenCV image operations of the training augmentations, in numpy
and PyTorch, so that the Kubric reader runs where OpenCV is missing (the GPU
machine has none):

  * `rgb_to_hsv_u8`: cv2.cvtColor(img, cv2.COLOR_RGB2HSV) on uint8, bit for
    bit (OpenCV's fixed-point division tables, a shift of 12; hue in
    [0, 180)). The way back is `utils.visualizer.hsv_to_rgb`;
  * `gaussian_blur_u8`: cv2.GaussianBlur(img, (k, k), sigma) on uint8, bit
    for bit: OpenCV's 8-bit path, whose kernel is rounded to 8 fraction bits
    with the rounding error carried from tap to tap, applied row then column
    in integers with BORDER_REFLECT_101;
  * `resize_linear`: cv2.resize(img, (w, h), interpolation=INTER_LINEAR) on
    float32, within float32 rounding: OpenCV's source coordinates (in
    double, the fraction rounded to float32 as its weight), rows then
    columns.
"""

import numpy as np
import torch

_HSV_SHIFT = 12
_DIV = np.arange(1, 256, dtype=np.float64)
# OpenCV's sdiv_table and hdiv_table180: round((255 << 12) / i) and
# round((180 << 12) / (6 i)), 0 at i = 0 (rint: OpenCV's saturate_cast)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _DIV)]).astype(np.int32)
_HDIV180 = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _DIV))]).astype(np.int32)


def rgb_to_hsv_u8(rgb):
    """(..., 3) uint8 RGB -> (..., 3) uint8 HSV with H in [0, 180), the codes
    of cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)."""
    rgb = np.asarray(rgb, np.uint8).astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def gaussian_kernel_u8(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's 8-bit Gaussian kernel: int64 taps in units of 1/256 that sum
    to 256. The float taps are exp(-x^2 / (2 sigma^2)) normalised to sum 1;
    the outer ones are rounded from the edge in, each carrying the previous
    rounding error, and the centre takes what is left."""
    if ksize % 2 != 1 or sigma <= 0:
        raise ValueError(f"an odd ksize and a positive sigma are needed, got {ksize}, {sigma}")
    half = ksize // 2
    x = np.arange(1 - ksize, 0, 2, dtype=np.float64)  # 2 * (i - half) for i < half
    vals = np.exp(x * x * (-0.125 / (sigma * sigma)))
    total = 0.0
    for t in vals:  # OpenCV's order of the sum
        total += t
    scale = 1.0 / (total * 2.0 + 1.0)
    taps = np.zeros(ksize, np.int64)
    err = 0.0
    for i, t in enumerate(vals):
        adj = t * scale * 256.0 + err
        taps[i] = taps[ksize - 1 - i] = int(np.rint(adj))
        err = adj - float(taps[i])
    taps[half] = 256 - 2 * int(taps[:half].sum())
    return taps


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source indices of a length-n axis padded by `pad` on both sides with
    BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba), repeated for short axes."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def _filter_axis(x, taps, axis):
    """Taps along `axis` of x (already padded there by len(taps) - 1)."""
    n = x.shape[axis] - len(taps) + 1
    return sum(float(t) * x.narrow(axis, i, n) for i, t in enumerate(taps) if t)


def gaussian_blur_u8(img, ksize: int = 11, sigma: float = 1.0):
    """(H, W[, C]) uint8 -> the same shape, the codes of
    cv2.GaussianBlur(img, (ksize, ksize), sigma) (see the module docstring):
    each row filtered with the integer taps, then each column, then rounded
    (sum + 2^15) >> 16. Every partial sum is an integer below 2^24
    (255 * 256 * 256), so float32 holds it exactly."""
    img = np.ascontiguousarray(img, np.uint8)
    taps = gaussian_kernel_u8(ksize, sigma)
    half = ksize // 2
    H, W = img.shape[:2]
    x = torch.from_numpy(img).float()
    x = _filter_axis(x[:, torch.from_numpy(_reflect101(W, half))], taps, 1)
    x = _filter_axis(x[torch.from_numpy(_reflect101(H, half))], taps, 0)
    return torch.floor((x + 32768.0) * (1.0 / 65536.0)).to(torch.uint8).numpy()


def _linear_taps(n_in: int, n_out: int):
    """OpenCV INTER_LINEAR's source index pairs and float32 weights along an
    axis: the source coordinate (d + 0.5) * (n_in / n_out) - 0.5 in double,
    its fraction rounded to float32; clamped to the first and last sample."""
    scale = 1.0 / (float(n_out) / n_in)
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= n_in - 1
    f[low | high] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.from_numpy(np.float32(1.0) - f), torch.from_numpy(f))


def resize_linear(img, out_hw):
    """(H, W, C) float32 -> (h, w, C) float32 for out_hw = (h, w), within
    float32 rounding of cv2.resize(img, (w, h), interpolation=INTER_LINEAR):
    OpenCV's sampling (half-pixel centres, no antialiasing, the edge
    sample repeated), its weights, rows first."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    H, W = x.shape[:2]
    h, w = out_hw
    x0, x1, a0, a1 = _linear_taps(W, w)
    y0, y1, b0, b1 = _linear_taps(H, h)
    rows = x.index_select(1, x0) * a0[:, None] + x.index_select(1, x1) * a1[:, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    return (rows.index_select(0, y0) * b0 + rows.index_select(0, y1) * b1).numpy()
