"""The two shape gates of the JAX package that choose which function an
updateformer block computes (pure Python, no kernel).

The tile sizes they return are TPU layout and mean nothing on the H100: the
port's kernels take any track and frame count. What the port keeps is the
decision they make. In the JAX package:

  * `pick_block_n(N)` is None (fewer than 256 tracks, or no multiple-of-8
    divisor of N in [256, 512]) -> the space blocks run plain XLA, and the
    updateformer switches the W8A8 time blocks off too (`quant_ok`);
  * `pick_time_tile(M, T, max_tokens)` is None (no track tile of at most
    `max_tokens` tokens divides M: videos longer than 128 frames for the
    point tokens, 192 for the virtual tokens) -> the time block runs the
    three-kernel split (LN + W8A8 qkv, attention core, W8A8 out + MLP)
    instead of the whole-block kernel. The split rounds the attention
    output to the token dtype before quantizing it, the whole block does
    not: in bfloat16 the two are different functions.

A third gate picks K11, the all-frames points<-virtual block, under the
`space_allt` variant switch (`space_allt_tile`). K11 and the K2 chain
compute the same function; the gate only decides which kernel runs, and the
launch counts pin it.

Copies of cotracker_tpu/ops/kernels/attention_pallas.py::pick_block_n and
mlp_int8_pallas.py::_pick_time_tile, _reshape_repack_ok and the all-frames
conditions of fused_space_block_int8.
"""

from typing import Optional

# the JAX updateformer's token caps per time-block tile: 1,024 for the point
# tokens (its lane-split 4D entry, taken whenever the W8A8 space blocks run)
# and 1,536 for the flat entry (the virtual tokens)
POINT_TOKENS, FLAT_TOKENS = 1024, 1536


def pick_block_n(N: int, cap: int = 512) -> Optional[int]:
    """Largest multiple-of-8 divisor of N in [256, cap], or None."""
    if N < 256:
        return None
    for b in range(min(cap, N), 255, -8):
        if N % b == 0:
            return b
    return None


def space_tile_ok(N: int) -> bool:
    """True where the JAX package runs its space-block kernels on N tracks."""
    return pick_block_n(N) is not None


def pick_time_tile(M: int, T: int, max_tokens: int = FLAT_TOKENS) -> Optional[int]:
    """The JAX whole-time-block kernel's track tile for M rows of T frames,
    or None when the block takes the three-kernel split."""
    tb = 16
    while tb * T < 768 and tb < 128 and M % (2 * tb) == 0:
        tb *= 2
    while tb > 8 and tb * T > max_tokens and M % (tb // 2) == 0:
        tb //= 2
    if tb * T > max_tokens or M % tb:
        return None
    return tb


def reshape_repack_ok(T: int, bf16: bool) -> bool:
    """T is a whole number of sublane tiles of the token dtype: 16 frames
    for bf16 tokens, 8 for float32."""
    return T % (16 if bf16 else 8) == 0


def space_allt_tile(N: int, T: int, bf16: bool) -> Optional[int]:
    """The track tile of the JAX all-frames points<-virtual block on N
    tracks of T frames, or None where the block keeps its per-frame route:
    N must take the space kernels at all, T must be a whole number of
    sublane tiles, a time-block track tile of at most 1,024 tokens must
    divide N, and the tile's tokens must split into at most 8 row chunks of
    at most 640."""
    if not space_tile_ok(N) or not reshape_repack_ok(T, bf16):
        return None
    tile = pick_time_tile(N, T, POINT_TOKENS)
    if tile is None:
        return None
    tokens = tile * T
    if not any(tokens % c == 0 and tokens // c <= 640 for c in range(1, 9)):
        return None
    return tile
