"""Model FLOPs of CoTracker3 from shapes: the published architecture's
multiply-adds, two FLOPs each, whatever precision the program computes
them in (its int8 products count as FLOPs too, against the bf16 peak of
`bounds.BF16_OPS`). Norms, activations, softmax and sampling are left
out. The encoder counts the frames a call encodes (a stream window
encodes only its new frames: the others' maps are the last window's)."""


def conv_flops(h, w, c_out, c_in, k):
    return 2 * h * w * c_out * c_in * k * k


def encoder_flops(H, W, d=128):
    """The RAFT BasicEncoder on one H x W frame."""
    f = conv_flops(H // 2, W // 2, d // 2, 3, 7)
    widths = [(d // 2, d // 2, 2), (d // 2, d // 4 * 3, 4), (d // 4 * 3, d, 8), (d, d, 16)]
    for i, (c_in, c, div) in enumerate(widths):
        h, w = H // div, W // div
        f += conv_flops(h, w, c, c_in, 3) + 3 * conv_flops(h, w, c, c, 3)
        if i > 0:
            f += conv_flops(h, w, c, c_in, 1)
    f += conv_flops(H // 4, W // 4, 2 * d, 3 * d + d // 4, 3)
    f += conv_flops(H // 4, W // 4, d, 2 * d, 1)
    return f


def _attn_block(tokens, ctx_len, C, hid):
    """A pre-norm block: q, k|v, out projections and the MLP on `tokens`
    query tokens, attention over ctx_len keys a query."""
    return tokens * (2 * C * 4 * C + 4 * C * hid) + tokens * 4 * ctx_len * C


def iteration_flops(N, T, cfg):
    C = cfg["hidden_size"]
    hid = int(C * cfg["mlp_ratio"])
    V, L, D = cfg["num_virtual_tracks"], cfg["corr_levels"], cfg["latent_dim"]
    P2 = (2 * cfg["corr_radius"] + 1) ** 2
    ch, co = cfg["corr_hidden"], cfg["corr_hidden_out"]
    input_dim = 2 + L * co + cfg["rel_posenc_dim"]
    nt, vt = N * T, V * T
    f = nt * L * 2 * (P2 * P2 * D + P2 * P2 * ch + ch * co)  # correlation and its MLP
    f += nt * 2 * input_dim * C  # the token projection
    # time blocks: point and virtual tokens, attention over the T frames
    f += cfg["time_depth"] * (_attn_block(nt, T, C, hid) + _attn_block(vt, T, C, hid))
    for _ in range(cfg["space_depth"]):
        # virtual <- points: q, out and the MLP on the virtual tokens, k|v on the points
        f += vt * (2 * C * 2 * C + 4 * C * hid) + nt * 2 * C * 2 * C + vt * 4 * N * C
        f += _attn_block(vt, V, C, hid)  # virtual self-attention
        # points <- virtual: q, out and the MLP on the points, k|v on the virtual tokens
        f += nt * (2 * C * 2 * C + 4 * C * hid) + vt * 2 * C * 2 * C + nt * 4 * V * C
    f += nt * 2 * C * 4  # flow and vis/conf heads
    return f


def call_flops(N, T, encoded, cfg):
    """One predictor call: `encoded` frames through the encoder, `iters`
    iterations over N tracks x T frames."""
    H, W = cfg["model_resolution"]
    return encoded * encoder_flops(H, W, cfg["latent_dim"]) + cfg["iters"] * iteration_flops(
        N, T, cfg)
