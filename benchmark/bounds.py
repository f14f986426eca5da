"""The least time of a layer's work on one H100, from shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit. A least
time is the larger of the bytes over the HBM rate and the operations over
the peak of their type (summed over types). `k1_bound`, `k2_bound` and
`k3_bound` are the W8A8 blocks' contracts as chip_smoke.py states them
(x read and written once, the int8 weight packs once; the int8 products at
the int8 peak, the attention core at the bf16 peak), taken from shapes
instead of tensors. `corr_bound` is the correlation layer's contract
(module docstring of `corr_call_s`). Nothing here reads a kernel name or a
launch count, so the work is the same whatever implements it.
"""

HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_OPS = 989e12
F32_OPS = 67e12

C, HID, HEADS, DH = 384, 1536, 8, 48  # the update transformer's widths
BF16 = 2


def bound_s(nbytes, ops):
    """Least seconds: bytes over HBM rate against the operations over the
    peak of their type (summed over types)."""
    return max(nbytes / HBM_BPS, sum(n / rate for n, rate in ops))


def qlinear_bytes(n_out, n_in):
    """An int8 weight pack: the codes, an f32 scale and an f32 bias a row."""
    return n_out * n_in + 8 * n_out


def k1_bound(M, T):
    """The W8A8 time block on M tracks x T frames."""
    w = (qlinear_bytes(3 * C, C) + qlinear_bytes(C, C) + qlinear_bytes(HID, C)
         + qlinear_bytes(C, HID))
    return bound_s(2 * M * T * C * BF16 + w,
                   [(M * T * 2 * C * (3 * C + C + 2 * HID), INT8_OPS),
                    (M * T * HEADS * 4 * T * DH, BF16_OPS)])


def k2_bound(M, T, V):
    """The W8A8 points <- virtual block: M point tokens a frame over V
    virtual keys and values (T, V, 2C)."""
    w = (qlinear_bytes(C, C) + qlinear_bytes(C, C) + qlinear_bytes(HID, C)
         + qlinear_bytes(C, HID))
    return bound_s(2 * M * T * C * BF16 + T * V * 2 * C * BF16 + w,
                   [(M * T * 2 * C * (2 * C + 2 * HID), INT8_OPS),
                    (M * T * HEADS * 4 * V * DH, BF16_OPS)])


def k3_bound(N, T, V):
    """The W8A8 virtual <- points projection and attention: V virtual
    queries a frame over the k|v of N point tokens."""
    nbytes = (T * V * C * BF16 + N * T * C * BF16 + qlinear_bytes(2 * C, C) + 4 * N
              + T * V * C * BF16)
    return bound_s(nbytes, [(N * T * 2 * C * 2 * C, INT8_OPS),
                            (T * HEADS * V * N * 4 * DH, BF16_OPS)])


def uf_call_s(N, T, cfg):
    """The update transformer's W8A8 blocks in one call of `cfg["iters"]`
    iterations: per time block the point and the virtual tokens, per space
    round the points <- virtual block and the virtual <- points projection
    and attention."""
    V = cfg["num_virtual_tracks"]
    per_iter = (cfg["time_depth"] * (k1_bound(N, T) + k1_bound(V, T))
                + cfg["space_depth"] * (k2_bound(N, T, V) + k3_bound(N, T, V)))
    return cfg["iters"] * per_iter


def corr_call_s(N, T, cfg):
    """The correlation layer in one call: per iteration and level, each
    (track, frame)'s 49 x 49 volume of 128-d int8 products and its first MLP
    layer (2401 -> 384) at the int8 peak, the second layer folded into the
    token projection (384 -> 384) at the bf16 peak; each level's int8 map
    and support read once and the bf16 tokens written once an iteration."""
    P2 = (2 * cfg["corr_radius"] + 1) ** 2
    D, L = cfg["latent_dim"], cfg["corr_levels"]
    h, w = (s // cfg["stride"] for s in cfg["model_resolution"])
    maps = sum(T * (h >> i) * (w >> i) * D for i in range(L))
    nbytes = maps + L * N * P2 * D + N * T * C * BF16
    int8 = N * T * L * 2 * P2 * P2 * (D + cfg["corr_hidden"])
    bf16 = N * T * L * 2 * cfg["corr_hidden"] * C
    return cfg["iters"] * bound_s(nbytes, [(int8, INT8_OPS), (bf16, BF16_OPS)])
