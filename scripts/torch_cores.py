"""The attention cores of the port on the card, alone: K5 (time, its long
route past 512 frames too), K6 (points <- virtual), K7 (virtual <- points)
and the K2 / K3 chains whose attention stages share K6's and K7's device
code, each against its plain version (max |err| / max |ref|) and timed with
CUDA events beside one scaled_dot_product_attention call on the same
operands (a yardstick; the port never calls it) and its byte bound.

    python3 scripts/torch_cores.py              # the main paths' shapes
    python3 scripts/torch_cores.py --sweep      # also K7 at each key-range count

One JSON line per measurement. Needs a CUDA card; bf16, random operands
from seed 0.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch
from torch.nn.functional import scaled_dot_product_attention as sdpa  # yardstick only

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, mlp_int8_cuda  # noqa: E402

C, H, D, V = 384, 8, 48, 64
HBM_BPS = 3.35e12  # H100 SXM


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def hm(t):
    return t.unflatten(-1, (H, D)).transpose(-2, -3)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def emit(**rec):
    print(json.dumps(rec), flush=True)


def k7_with_splits(q, kv, bias, splits):
    """ct_k7_virtual_from_points with an explicit key-range count."""
    T, _, _ = q.shape
    part = torch.empty((splits * T * V * (C + 2 * H),), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _build.check(attention_cuda._cores_lib()["k7"](
        q.data_ptr(), kv.data_ptr(), bias.data_ptr(), 1, out.data_ptr(), part.data_ptr(), splits,
        kv.shape[0], T, V, H, D, D**-0.5, _build.stream_ptr(q)), "ct_k7_virtual_from_points")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="K7 at 1-16 key ranges")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_cores: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         build_s=round(_build.build_all()[0], 1))
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    A, M = attention_cuda, mlp_int8_cuda

    for N, T in ((10240, 16), (10240, 60)):
        x = torch.randn(N, T, C, generator=g).to(dev, bf)
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, bf)
        q6 = hm(x.transpose(0, 1))
        emit(core="K6", tracks=N, frames=T,
             err=rel_err(A.fused_points_from_virtual(x, kv, H, D), A.p2v_plain(x, kv, H, D)),
             ms=time_ms(lambda: A.fused_points_from_virtual(x, kv, H, D)),
             sdpa_ms=time_ms(lambda: sdpa(q6, hm(kv[..., :C]), hm(kv[..., C:]))),
             bound_ms=1e3 * 2 * nbytes(x) / HBM_BPS)
        q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, bf)
        kv7 = torch.randn(N, T, 2 * C, generator=g).to(dev, bf)
        bias = torch.zeros(N, device=dev)
        k7t, mask = kv7.transpose(0, 1), bias.to(bf)[None, None, None, :]
        emit(core="K7", tracks=N, frames=T, splits=A.v2p_splits(N, T, V, H, dev),
             err=rel_err(A.fused_virtual_from_points(q, kv7, H, D, key_bias=bias),
                         A.v2p_plain(q, kv7, H, D, key_bias=bias)),
             ms=time_ms(lambda: A.fused_virtual_from_points(q, kv7, H, D, key_bias=bias)),
             sdpa_ms=time_ms(lambda: sdpa(hm(q), hm(k7t[..., :C]), hm(k7t[..., C:]),
                                          attn_mask=mask)),
             bound_ms=1e3 * nbytes(kv7) / HBM_BPS)
        if args.sweep:
            emit(core="K7", tracks=N, frames=T, ms_by_splits={
                s: time_ms(lambda: k7_with_splits(q, kv7, bias, s)) for s in (1, 2, 3, 4, 6, 8,
                                                                              12, 16)})
        del x, kv, kv7

    M5, T5 = 256, 640
    x = torch.randn(M5, T5, C, generator=g).to(dev, bf)
    kv5 = torch.randn(M5, T5, 2 * C, generator=g).to(dev, bf)
    emit(core="K5", tracks=M5, frames=T5,
         err=rel_err(A.fused_time_attention(x, kv5, H, D), A.time_attention_plain(x, kv5, H, D)),
         ms=time_ms(lambda: A.fused_time_attention(x, kv5, H, D), reps=5),
         sdpa_ms=time_ms(lambda: sdpa(hm(x), hm(kv5[..., :C]), hm(kv5[..., C:])), reps=5),
         bound_ms=1e3 * nbytes(x, kv5, x) / HBM_BPS)

    def lin(o, i):
        w = torch.randn(o, i, generator=g) / math.sqrt(i)
        return M.quantize_linear(w.to(dev), (0.05 * torch.randn(o, generator=g)).to(dev))

    sw = M.SpaceBlockWeights(lin(C, C), lin(C, C), lin(4 * C, C), lin(C, 4 * C))
    wkv = lin(2 * C, C)
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev)
    beta = (0.05 * torch.randn(C, generator=g)).to(dev)
    for N, T in ((10240, 16), (10240, 60)):
        x = torch.randn(N, T, C, generator=g).to(dev, bf)
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, bf)
        emit(chain="K2", tracks=N, frames=T,
             err=rel_err(M.fused_space_block_int8(x, kv, sw, H, D),
                         M.space_block_plain(x, kv, sw, H, D)),
             ms=time_ms(lambda: M.fused_space_block_int8(x, kv, sw, H, D)))
        q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, bf)
        bias = torch.zeros(N, device=dev)
        a = (q, x, wkv, gamma, beta, H, D, bias)
        emit(chain="K3", tracks=N, frames=T,
             err=rel_err(A.fused_virtual_from_points_proj(*a), A.v2p_proj_plain(*a)),
             ms=time_ms(lambda: A.fused_virtual_from_points_proj(*a)))


if __name__ == "__main__":
    main()
