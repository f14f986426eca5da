"""The tilings the kernel wrappers compute in Python before a launch, pure
Python (no kernel, no JAX): K1's two-launch plan (`mlp_int8_cuda.k1_plan`)
for every (tracks, frames) the frame gate sends to the whole time block,
and K5's route for every frame count (`attention_cuda.k5_plan`). On the
card, `tests/test_torch_cuda.py` holds the kernels to these plans (K1's
shared-memory arithmetic against `ct_k1_smem`) and each route to the plain
version.
"""

import re

import pytest

from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, gates, mlp_int8_cuda

# track counts: the gate's tile divides some and not others (odd, prime,
# the predictors' padded grids and the quasi-dense count, the 64 virtual tracks)
TRACKS = (8, 16, 24, 37, 64, 256, 264, 512, 1000, 2560, 10240, 70656)


def test_k1_plan_fits_every_gated_shape():
    admitted = set()
    for M in TRACKS:
        for T in range(1, 300):
            if any(gates.pick_time_tile(M, T, cap) is not None
                   for cap in (gates.POINT_TOKENS, gates.FLAT_TOKENS)):
                admitted.add(T)
                p = mlp_int8_cuda.k1_plan(M, T)
                assert max(p.front_smem, p.tail_smem) <= mlp_int8_cuda.SMEM_LIMIT, (M, T, p)
                assert p.tracks * T <= p.rows_pad and p.rows_pad % 64 == 0, (M, T, p)
                assert p.front_blocks * p.tracks >= M and p.tail_blocks * 64 >= M * T
                if T <= 64:  # several whole tracks in one 64-row tile
                    assert (p.nc, p.tracks, p.rows_pad) == (1, 64 // T, 64)
                else:  # one track a block, its key chunks in registers or in passes
                    assert p.tracks == 1 and p.nc == (2 if T <= 128 else 0)
    assert max(admitted) == 192 and set(range(1, 193)) <= admitted
    # the rings' template parameters as int8_time_block.cu states them
    src = (_build.CSRC / "int8_time_block.cu").read_text()
    for name, ring in (("FrontTileGemm", mlp_int8_cuda.K1_FRONT_TILE_RING),
                       ("FrontTrackGemm", mlp_int8_cuda.K1_FRONT_TRACK_RING)):
        _, NW, _, NI, BK, STAGES = map(int, re.search(
            rf"using {name} = RingGemm<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>;", src).groups())
        assert ring == mlp_int8_cuda._ring_bytes(NW=NW, NI=NI, BK=BK, STAGES=STAGES), name
    slot, slots = re.search(r"constexpr int K1T_SLOT = ([\d +*()]+), K1T_SLOTS = (\d+);",
                            src).groups()
    assert (mlp_int8_cuda.K1T_SLOT, mlp_int8_cuda.K1T_SLOTS) == (eval(slot), int(slots))
    assert mlp_int8_cuda.k1_plan(10240, 60).front_smem == 231168
    assert mlp_int8_cuda.k1_plan(10240, 60).tail_smem == 228704
    with pytest.raises(ValueError, match="frames"):
        mlp_int8_cuda.k1_plan(64, mlp_int8_cuda.K1_MAX_T + 1)


def test_k5_routes_cover_every_frame_count():
    H = 8
    for bf16 in (True, False):
        routes = []
        for T in range(1, 1025):
            p = attention_cuda.k5_plan(T, H, bf16)
            routes.append(p.route)
            if p.route == "tc":
                assert p.smem == 3 * p.hs * p.rows_pad * 48 * 2 <= mlp_int8_cuda.SMEM_LIMIT
                assert 1 <= p.hs <= H and p.tracks * T <= p.rows_pad and p.rows_pad % 64 == 0
                assert p.nc == 0 or p.rows_pad == 64 * p.nc
                assert p.tracks == (64 // T if T <= 64 else 1)
        short, long_ = ("tc", "long") if bf16 else ("staged", "long_f32")
        assert routes == [short] * 512 + [long_] * 512
    assert attention_cuda.k5_plan(60, H, True).smem <= attention_cuda.K5_BLOCK_BYTES
    with pytest.raises(ValueError):
        attention_cuda.k5_plan(0, H, True)
