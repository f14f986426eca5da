"""The tilings the kernel wrappers compute in Python before a launch, pure
Python (no kernel, no JAX): K1's two-launch plan (`mlp_int8_cuda.k1_plan`)
for every (tracks, frames) the frame gate sends to the whole time block,
K5's route for every frame count (`attention_cuda.k5_plan`), K4's cluster
tiling (`corr_cuda.k4_plan`), K9's body by token dtype
(`mlp_int8_cuda.k9_route`), K2's route and front (`mlp_int8_cuda.k2_plan`),
which K11 takes too, K3's key ranges and head groups
(`attention_cuda.k3_plan`), K12's clusters (`mlp_int8_cuda.k12_plan`),
K10's streamed route (`mlp_int8_cuda.k10_plan`) and K4f's persistent
tasks (`corr_cuda.k4f_plan`). On the
card, `tests/test_torch_cuda.py` holds the kernels to these plans (K1's,
K2's, K3's and K4's shared-memory arithmetic against `ct_k1_smem`,
`ct_k2_smem`, `ct_k3_smem` and `ct_k4_smem`) and each route to the plain
version.
"""

import re

import pytest

import torch

from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, corr_cuda, gates, mlp_int8_cuda

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


@pytest.mark.parametrize("Tp", [2, 16, 60, 250, 600])
def test_k4_plan_covers_every_frame_once(Tp):
    """K4's cluster splits a point's frames into disjoint ranges that cover
    them all, one range a block; up to 64 frames every block holds its
    frames' volume (at most 8, one region each: one pass), past that a
    cluster of 8 takes two passes; a block fits the card's shared memory.
    The plan's constants are corr_window.cu's."""
    p = corr_cuda.k4_plan(37, Tp)
    frames = [t for k in range(p.cluster) for t in corr_cuda.k4_frames(Tp, p.cluster, k)]
    assert frames == list(range(Tp))
    assert max(len(corr_cuda.k4_frames(Tp, p.cluster, k)) for k in range(p.cluster)) == p.frames
    assert min(len(corr_cuda.k4_frames(Tp, p.cluster, k)) for k in range(p.cluster)) >= 1
    assert p.smem <= mlp_int8_cuda.SMEM_LIMIT and p.blocks == 37 * p.cluster
    assert 1 <= p.cluster <= corr_cuda.K4_MAX_CLUSTER
    if Tp <= 64:
        assert p.hold and p.frames <= corr_cuda.K4_REGIONS and p.cluster == -(-Tp // 8)
    else:
        assert not p.hold and p.cluster == corr_cuda.K4_MAX_CLUSTER
    src = (_build.CSRC / "corr_window.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kK4\w+) = (\d+);", src))
    assert int(consts["kK4Regions"]) == corr_cuda.K4_REGIONS
    assert int(consts["kK4MaxCluster"]) == corr_cuda.K4_MAX_CLUSTER
    assert int(consts["kK4Ld"]) * 64 * 4 * corr_cuda.K4_REGIONS + 56 * 128 + 32 == p.smem


def test_k9_route_by_dtype():
    """K9 in bfloat16 runs K1's streamed tail with K9's prologue; float32
    keeps the 64-row tile body; other dtypes raise."""
    assert mlp_int8_cuda.k9_route(torch.bfloat16) == "tail"
    assert mlp_int8_cuda.k9_route(torch.float32) == "tile"
    with pytest.raises(TypeError):
        mlp_int8_cuda.k9_route(torch.float16)


def _ring(src, name):
    """(NW, NI, BK, STAGES) of `using name = RingGemm<MW, NW, MI, NI, BK, STAGES>;`."""
    _, NW, _, NI, BK, STAGES = map(int, re.search(
        rf"using {name} = RingGemm<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>;", src).groups())
    return dict(NW=NW, NI=NI, BK=BK, STAGES=STAGES)


def test_k2_plan_fits_and_routes():
    """K2 takes the fused front (then K1's tail) for bf16 tokens and keys
    with up to 64 virtual tokens, the chain otherwise; the front's blocks
    split the frame-major list of 64-track tiles into non-empty runs; both
    kernels fit an H100 block's shared memory. Its constants are
    int8_time_block.cu's."""
    bf, f32 = torch.bfloat16, torch.float32
    for N in TRACKS:
        for T in (1, 2, 5, 16, 60, 61, 192, 250, 600):
            for sms in (132, 114):
                p = mlp_int8_cuda.k2_plan(N, T, 64, bf, sms=sms)
                assert p.route == "fused" and p.tiles == -(-N // 64) * T
                assert 1 <= p.blocks <= min(p.tiles, sms)
                runs = [(p.tiles * b // p.blocks, p.tiles * (b + 1) // p.blocks)
                        for b in range(p.blocks)]
                assert runs[0][0] == 0 and runs[-1][1] == p.tiles
                assert all(a < b == c for (a, b), (c, _) in zip(runs, runs[1:] + [(p.tiles, 0)]))
                assert max(p.front_smem, p.tail_smem) <= mlp_int8_cuda.SMEM_LIMIT
                assert p.tail_blocks * 64 >= N * T
    for V, dtype, kv_dtype in ((65, bf, bf), (64, f32, f32), (64, bf, f32), (512, bf, bf)):
        assert mlp_int8_cuda.k2_plan(300, 5, V, dtype, kv_dtype).route == "chain"
    assert mlp_int8_cuda.k2_plan(300, 5, 1, bf).route == "fused"
    with pytest.raises(TypeError):
        mlp_int8_cuda.k2_plan(300, 5, 64, torch.float16)
    src = (_build.CSRC / "int8_time_block.cu").read_text()
    assert mlp_int8_cuda.K2_Q_RING == mlp_int8_cuda._ring_bytes(**_ring(src, "K2QGemm"))
    consts = dict(re.findall(r"constexpr int (K2_TILE|K2_MAX_V) = (\d+);", src))
    assert (int(consts["K2_TILE"]), int(consts["K2_MAX_V"])) == (64, mlp_int8_cuda.K2_MAX_V)
    assert mlp_int8_cuda.k2_plan(10240, 60, 64, bf).front_smem == 216848


@pytest.mark.parametrize("N", TRACKS)
def test_k3_ranges_cover_every_key_once(N):
    """K3's key ranges (the plan's, and every count from 1 to 16) are whole
    64-point tiles but the last, cover the N keys once in order, and hold
    at least 2,048 keys each but the last where there is more than one;
    the plan's blocks fit an H100 block's shared memory. Its constants
    are int8_v2p_proj.cu's."""
    A = attention_cuda
    for T in (1, 16, 60, 250):
        p = A.k3_plan(N, T, 64, torch.bfloat16)
        assert p.route == "fused" and p.heads in (8, 4) and p.smem <= mlp_int8_cuda.SMEM_LIMIT
        assert p.smem == A.k3_smem(p.heads) and p.blocks == T * p.splits * (8 // p.heads)
        ranges = A.k3_ranges(N, p.split_keys)
        assert len(ranges) == p.splits and p.split_keys % A.K3_KEYS == 0
        if p.splits > 1:
            assert min(e - b for b, e in ranges[:-1]) >= A.V2P_RANGE_KEYS
    for s in range(1, 17):
        ranges = A.k3_ranges(N, A.k3_split_keys(N, s))
        keys = [k for b, e in ranges
                for k0 in range(b, e, A.K3_KEYS) for k in range(k0, min(e, k0 + A.K3_KEYS))]
        assert keys == list(range(N)) and len(ranges) <= s
        assert all((e - b) % A.K3_KEYS == 0 for b, e in ranges[:-1])
    assert A.k3_plan(N, 16, 64, torch.float32).route == "chain"
    assert A.k3_plan(N, 16, 64, torch.bfloat16, torch.float32).route == "chain"
    src = (_build.CSRC / "int8_v2p_proj.cu").read_text()
    assert A.K3_KV_RING == mlp_int8_cuda._ring_bytes(**_ring(src, "K3KvGemm"))
    assert int(re.search(r"constexpr int K3_KEYS = (\d+);", src).group(1)) == A.K3_KEYS
    assert "int8_v2p_proj" in _build.SOURCES


@pytest.mark.parametrize("sms", [132, 114])
def test_k8_plan_covers_every_row_once(sms):
    """K8 in bfloat16 runs persistent blocks, one an SM, each a non-empty
    contiguous run of the 128-row tiles, together every tile once; a block
    fits the card's shared memory; float32 keeps the PR 4 body (one block a
    tile). The plan's constants are int8_time_block.cu's."""
    for rows in (1, 127, 128, 129, 222, 16000, 16001, 512000, 640000):
        p = mlp_int8_cuda.k8_plan(rows, torch.bfloat16, sms=sms)
        assert p.route == "stream" and p.tiles == -(-rows // mlp_int8_cuda.K8_BM)
        assert 1 <= p.blocks <= min(p.tiles, sms) and p.smem <= mlp_int8_cuda.SMEM_LIMIT
        runs = [range(p.tiles * b // p.blocks, p.tiles * (b + 1) // p.blocks)
                for b in range(p.blocks)]
        assert [i for r in runs for i in r] == list(range(p.tiles)) and min(map(len, runs)) >= 1
        assert (p.tiles - 1) * mlp_int8_cuda.K8_BM < rows <= p.tiles * mlp_int8_cuda.K8_BM
        assert mlp_int8_cuda.k8_plan(rows, torch.float32, sms=sms).route == "tile"
    with pytest.raises(TypeError):
        mlp_int8_cuda.k8_plan(128, torch.float16)
    src = (_build.CSRC / "int8_time_block.cu").read_text()
    consts = re.search(r"constexpr int K8_BM = (\d+), K8_SLOTS = (\d+), K8_XBUF = (\d+);", src)
    assert tuple(map(int, consts.groups())) == (
        mlp_int8_cuda.K8_BM, mlp_int8_cuda.K8_SLOTS, mlp_int8_cuda.K8_XBUF)
    assert mlp_int8_cuda.K8_SMEM == 207968


@pytest.mark.parametrize("Tp", [6, 16, 24, 60, 80, 250])
def test_k4m_plan_covers_every_row_once(Tp):
    """K4m's code rows come from K4's cluster tiling (every frame of a point
    once, held on chip up to 64 frames); its MLP1 blocks take 128 code rows
    each, several points' frames, every row of the NP * Tp once; both
    kernels fit a block's shared memory. The constants are corr_window.cu's."""
    for NP in (1, 37, 38, 2048):
        p = corr_cuda.k4m_plan(NP, Tp)
        assert p.volume == corr_cuda.k4_plan(NP, Tp)
        frames = [t for k in range(p.volume.cluster)
                  for t in corr_cuda.k4_frames(Tp, p.volume.cluster, k)]
        assert frames == list(range(Tp)) and p.volume.hold == (Tp <= 64)
        rows = NP * Tp
        assert (p.gemm_blocks - 1) * corr_cuda.K4M_ROWS < rows <= p.gemm_blocks * corr_cuda.K4M_ROWS
        assert max(p.gemm_smem, p.volume.smem) <= mlp_int8_cuda.SMEM_LIMIT
    src = (_build.CSRC / "corr_window.cu").read_text()
    consts = dict(re.findall(r"\b(kMlpBM|kMlpStages|kMlpBK) = (\d+)", src))
    assert (int(consts["kMlpBM"]), int(consts["kMlpStages"]), int(consts["kMlpBK"])) == (
        corr_cuda.K4M_ROWS, corr_cuda.K4M_STAGES, 64)
    assert corr_cuda.K4M_GEMM_SMEM == 205312


@pytest.mark.parametrize("N", [384, 1152])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_k10_plan_covers_every_row_once(sms, N):
    """K10 in bfloat16 runs K8's streamed body (N / 128 column tiles a row
    tile): persistent blocks, one an SM, each a non-empty contiguous run of
    the 128-row tiles, together every row once; float32 keeps its first
    body; N must be a multiple of 128."""
    M = mlp_int8_cuda
    for rows in (8, 136, 1000, 16000, 604800):
        p = M.k10_plan(rows, N, torch.bfloat16, sms=sms)
        assert p == M.k8_plan(rows, torch.bfloat16, sms=sms) and p.route == "stream"
        assert 1 <= p.blocks <= min(p.tiles, sms) and p.smem == M.K8_SMEM <= M.SMEM_LIMIT
        runs = [range(p.tiles * b // p.blocks, p.tiles * (b + 1) // p.blocks)
                for b in range(p.blocks)]
        covered = [r for run in runs for i in run
                   for r in range(i * M.K8_BM, min(rows, (i + 1) * M.K8_BM))]
        assert covered == list(range(rows)) and min(map(len, runs)) >= 1
        assert M.k10_plan(rows, N, torch.float32, sms=sms).route == "tile"
    with pytest.raises(ValueError, match="multiple of 128"):
        M.k10_plan(128, N + 64, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NP,Tp", [(1, 1), (37, 5), (40, 16), (38, 17), (130, 60), (16, 250)])
def test_k4f_plan_covers_every_task_once(NP, Tp, dtype):
    """K4f's persistent blocks (one an SM, at most one a task), each taking
    tasks b, b + blocks, ... of the group-major list (task k: point k % NP,
    frames from (k // NP) * group), cover every (point, frame) once; the
    blocks' first tasks share their frames."""
    for sms in (132, 7):
        for group in (None, 1, 2, 4, 7):
            p = corr_cuda.k4f_plan(NP, Tp, dtype, sms, group)
            assert p.group == (min(Tp, corr_cuda.K4F_GROUP) if group is None else group)
            assert p.tasks == -(-Tp // p.group) * NP and 1 <= p.blocks == min(p.tasks, sms)
            tasks = [k for b in range(p.blocks) for k in range(b, p.tasks, p.blocks)]
            pairs = [(k % NP, t) for k in tasks
                     for t in range(k // NP * p.group, min(Tp, (k // NP + 1) * p.group))]
            assert sorted(pairs) == [(q, t) for q in range(NP) for t in range(Tp)]
            assert {b // NP for b in range(min(p.blocks, NP))} == {0}
    with pytest.raises(TypeError):
        corr_cuda.k4f_plan(4, 4, torch.float16)
    with pytest.raises(ValueError):
        corr_cuda.k4f_plan(4, 4, torch.float32, group=0)


def _k12_consts():
    """int8_mlp_cluster.cu's K12_* constants, evaluated in order."""
    src = (_build.CSRC / "int8_mlp_cluster.cu").read_text()
    env = dict(KC=384, KH=1536, LDA_C=384 + 16, LDA_H=1536 + 16)
    for name, expr in re.findall(r"constexpr int (K12_\w+) = ([^;]+);", src):
        env[name] = eval(expr.replace("/", "//"), {}, env)
    return env


@pytest.mark.parametrize("max_clusters", [1, 3, 14, 16, 132])
def test_k12_plan_covers_every_tile_once(max_clusters):
    """K12's clusters (at most the card's max active count, at most one a
    64-row tile) take the tiles c, c + clusters, ...: every tile once, no
    cluster idle; a block's shared memory, as int8_mlp_cluster.cu's
    constants give it, fits the card and is the plan's."""
    M = mlp_int8_cuda
    k = _k12_consts()
    assert (k["K12_CLUSTER"], k["K12_BM"]) == (M.K12_CLUSTER, M.K12_BM)
    assert k["K12_SMEM"] == M.K12_SMEM <= M.SMEM_LIMIT
    assert k["K12_HB"] * k["K12_CLUSTER"] == 1536 and k["K12_NB"] * k["K12_CLUSTER"] == 384
    for rows in (1, 8, 64, 65, 120, 64 * 8 * 3 + 40, 9999, 604800):
        p = M.k12_plan(rows, max_clusters)
        assert p.tiles == -(-rows // M.K12_BM) and p.smem == M.K12_SMEM
        assert 1 <= p.clusters == min(p.tiles, max_clusters)
        assert p.blocks == M.K12_CLUSTER * p.clusters
        tiles = sorted(t for c in range(p.clusters) for t in M.k12_tiles(p, c))
        assert tiles == list(range(p.tiles))
        assert min(len(M.k12_tiles(p, c)) for c in range(p.clusters)) >= 1
    with pytest.raises(RuntimeError, match="seats no"):
        M.k12_plan(64, 0)
    with pytest.raises(ValueError):
        M.k12_plan(0, 16)
    assert "int8_mlp_cluster" in _build.SOURCES


def test_k11_takes_k2s_route(monkeypatch):
    """K11 computes K2's function, so its wrapper routes by k2_plan: bf16
    tokens and keys with up to 64 virtual tokens K2's fused launches under
    K11's entry, float32 or 65-128 virtual tokens K2's chain; past 128 it
    raises. A call probe on meta tensors, with the launches replaced."""
    M = mlp_int8_cuda
    routes = []
    monkeypatch.setattr(M, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(M, "_sms", lambda device: 132)
    monkeypatch.setattr(M, "_space_block_fused",
                        lambda *a, entry="k2", **k: routes.append(("fused", entry, a[-1].route)))
    monkeypatch.setattr(M, "_space_block_chain", lambda *a, **k: routes.append(("chain",)))
    w = M.SpaceBlockWeights(*(M.QLinear(torch.empty(o, i, dtype=torch.int8, device="meta"),
                                        torch.empty(o, device="meta"), torch.empty(o, device="meta"))
                              for o, i in ((384, 384), (384, 384), (1536, 384), (384, 1536))))
    n2 = M.fused_space_block_int8.launches
    for dtype in (torch.bfloat16, torch.float32):
        for V in (1, 64, 65, 96, 128):
            x = torch.empty(300, 16, 384, dtype=dtype, device="meta")
            kv = torch.empty(16, V, 768, dtype=dtype, device="meta")
            M.fused_space_block_allt_int8(x, kv, w, 8, 48)
            want = ("fused", "k11", "fused") if dtype == torch.bfloat16 and V <= 64 else ("chain",)
            assert routes.pop() == want, (dtype, V)
        with pytest.raises(ValueError, match="K11 takes"):
            M.fused_space_block_allt_int8(x, torch.empty(16, 129, 768, dtype=dtype, device="meta"),
                                          w, 8, 48)
    assert M.fused_space_block_int8.launches == n2


@pytest.mark.parametrize("Tp", [1, 16, 60, 80])
def test_k4r_takes_k4s_cluster_kernel(monkeypatch, Tp):
    """K4r runs K4's cluster kernel in its K4r mode on k4_plan's tiling. A
    call probe on meta tensors, with the launch helper replaced: one launch
    a call with no (wx, wy) (the K4r mode) on k4_plan(NP, Tp), every frame
    held on chip up to 64 frames, two passes past that, counted once. The
    plan is one K4's entries take: at most corr_window.cu's kK4MaxCluster
    blocks, no more than the frames, and held only where a block's frames
    fit its kK4Regions regions."""
    C = corr_cuda
    calls = []
    monkeypatch.setattr(C, "_check_operands", lambda *a, **k: None)
    monkeypatch.setattr(C, "_k4_launch", lambda *a: calls.append(a) or ("vol", "scale"))
    monkeypatch.setattr(C.corr_volume_raw_int8, "launches", 0)
    NP = 37
    fmq = torch.empty(Tp, 112, 144, 128, dtype=torch.int8, device="meta")
    supq = torch.empty(NP, 49, 128, dtype=torch.int8, device="meta")
    starts = torch.empty(NP, Tp, 3, dtype=torch.int32, device="meta")
    assert C.corr_volume_raw_int8(fmq, supq, starts) == ("vol", "scale")
    (_, _, _, wxy, plan), = calls
    assert wxy is None and plan == C.k4_plan(NP, Tp) and plan.hold == (Tp <= 64)
    assert C.corr_volume_raw_int8.launches == 1

    src = (_build.CSRC / "corr_window.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (kK4\w+) = (\d+);", src)}
    assert 1 <= plan.cluster <= min(consts["kK4MaxCluster"], Tp)
    assert plan.frames == -(-Tp // plan.cluster)
    assert (plan.frames <= consts["kK4Regions"]) == plan.hold
