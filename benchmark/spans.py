"""Spans at the program's layer boundaries, opened from the benchmark's own
files, and the reduction of a device trace to busy time, idle gaps and
device seconds a span.

A span marks its entry and its exit on the device's timeline with a
marker kernel (`torch.cuda._sleep`, `spin_kernel` in the trace) in the
program's stream; the device runs that stream in order, so the device
operations between an entry's marker and its exit's are the ones the span
launched. Markers also open and close the traced window, so the window's
length and its busy time are read on one clock. A marker spins for one of
four lengths, by its index modulo four, so that the trace's markers are
matched to the host's marks even where the profiler lost a record.

Layers and where their spans open:
- `encoder`: the model's `compute_fmaps` and `build_pyramid` (the fnet,
  the L2 normalisation and the pyramid);
- `corr`: the module attributes `fused_corr_tokens` and
  `fused_corr_embs_trainable` of `cotracker_tpu_torch.ops.kernels.corr_cuda`,
  which the model's iteration looks up at each call;
- `uf`: forward pre and post hooks on `model.updateformer`.
A missing attribute raises: a span never reads 0 for want of its hook.
"""

import functools

import torch

MARKER = "spin_kernel"
CODES = (0, 16_000, 48_000, 128_000)  # a marker's spin cycles, by its index modulo 4
BANDS_US = (4.0, 15.0, 40.0)  # device microseconds between the codes' lengths
MAX_LOST = 8  # marker records the trace may lose before nothing is attributed
# the traced run's device operations, grouped by kernel name (first match wins)
GROUPS = (
    ("K4m corr_mlp1_kernel", ("corr_mlp1_kernel",)),
    ("K11 front (bf16) k11_front_kernel", ("k11_front_kernel",)),
    ("K8 ln_qkv_kernel", ("ln_qkv_kernel",)),
    ("K9 k9_tail_kernel (f32: attnout_mlp_kernel)", ("k9_tail_kernel", "attnout_mlp_kernel")),
    ("K1 front (bf16) k1_front_kernel", ("k1_front_kernel",)),
    ("K1 tail (bf16; also K2's and K11's second launch) k1_tail_kernel", ("k1_tail_kernel",)),
    ("K1-K3 s8 GEMM (gemm_s8_kernel)", ("gemm_s8_kernel",)),
    ("K1-K3 LN + row quant (ln_quant_kernel)", ("ln_quant_kernel",)),
    ("K4 corr_volume_kernel", ("corr_volume_kernel",)),
    ("time core (K5; K1's f32 chain) time_tc_kernel (f32: time_attention_kernel)",
     ("time_tc_kernel", "time_attention_kernel", "time_attention_long")),
    ("points<-virtual core (K2 stage / K6) p2v_tc_kernel (f32: p2v_attention_kernel)",
     ("p2v_tc_kernel", "p2v_attention_kernel")),
    ("virtual<-points core (K3 stage / K7) v2p_tc_kernel + merge (f32: v2p_flash_kernel)",
     ("v2p_tc_kernel", "v2p_merge_kernel", "v2p_flash_kernel")),
    ("convolutions (fnet)", ("conv", "cudnn", "fprop", "implicit_gemm", "nchw", "nhwc")),
    ("library GEMMs (cuBLAS / CUTLASS)", ("gemm", "cutlass", "cublas", "xmma", "gemv", "nvjet")),
)
TOP = 10


def group_of(name):
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return name[:100]


class Spans:
    """The marks a traced run enqueued, in order: (span, "enter" | "exit"),
    and the window's ("window", "warm" | "open" | "close")."""

    def __init__(self):
        self.marks = []

    def _put(self, mark):
        torch.cuda._sleep(CODES[len(self.marks) % len(CODES)])
        self.marks.append(mark)

    def enter(self, name):
        self._put((name, "enter"))

    def exit(self, name):
        self._put((name, "exit"))

    def open_window(self, warm=3):
        """Mark the traced window's start, after `warm` markers that let the
        profiler settle."""
        self.marks.clear()
        for _ in range(warm):
            self._put(("window", "warm"))
        torch.cuda.synchronize()
        self._put(("window", "open"))

    def close_window(self):
        self._put(("window", "close"))
        torch.cuda.synchronize()

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def spanned(*a, **k):
            self.enter(name)
            try:
                return fn(*a, **k)
            finally:
                self.exit(name)

        return spanned


def instrument(model, spans):
    """Open the three layers' spans around the program's calls."""
    from cotracker_tpu_torch.ops.kernels import corr_cuda

    for attr in ("compute_fmaps", "build_pyramid"):
        setattr(model, attr, spans.wrap("encoder", getattr(model, attr)))
    for attr in ("fused_corr_tokens", "fused_corr_embs_trainable"):
        setattr(corr_cuda, attr, spans.wrap("corr", getattr(corr_cuda, attr)))
    uf = model.updateformer
    uf.register_forward_pre_hook(lambda m, a: spans.enter("uf"))
    uf.register_forward_hook(lambda m, a, out: spans.exit("uf"))


def device_ops(prof):
    """(name, start ns, end ns) of every device operation in a
    torch.profiler run, by start; a marker is kept whatever its length,
    since the shortest code may read 0 ns."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and (
                e.duration_ns() > 0 or MARKER in e.name()):
            ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    ops.sort(key=lambda o: o[1])
    return ops


def _code(start, end):
    us = (end - start) / 1e3
    return sum(us > b for b in BANDS_US)


def match_markers(markers, marks):
    """The host mark of each marker record, by the codes of their lengths:
    a mark whose code the next record does not carry was lost. Raises
    ValueError past MAX_LOST lost records or where the window's own marks
    are lost."""
    at, j = [], 0
    for _, s, e in markers:
        c = _code(s, e)
        while j < len(marks) and j % len(CODES) != c:
            j += 1
        if j >= len(marks):
            raise ValueError("the trace's markers do not follow the host's marks")
        at.append(j)
        j += 1
    found = {marks[j] for j in at}
    lost = len(marks) - len(at)
    if lost > MAX_LOST or not {("window", "open"), ("window", "close")} <= found:
        raise ValueError(f"{lost} of {len(marks)} markers lost from the trace")
    return at


def reduce_timeline(ops, marks):
    """Device ops (name, start, end) in ns by start, and the marks the host
    enqueued (`Spans.marks`). Returns {"window_s", "busy_s", "lost_marks",
    "spans": {name: {"device_s", "count"}}, "device_ops": [[group, s]],
    "idle_gaps": [[label, s]]}. A lost mark's span change takes effect at
    the next marker the trace holds."""
    markers = [o for o in ops if MARKER in o[0]]
    at = match_markers(markers, marks)
    index = {m: at[i] for i, m in enumerate(markers)}
    j_open, j_close = marks.index(("window", "open")), marks.index(("window", "close"))
    t_begin = next(m[1] for m in markers if index[m] == j_open)
    t_end = next(m[2] for m in markers if index[m] == j_close)
    spans, by_group = {}, {}
    busy, gaps = 0, []
    cur_end, prev_name = t_begin, "window start"
    open_span, done = None, 0
    for op in ops:
        name, s, e = op
        if MARKER in name:
            for span, what in marks[done:index[op] + 1]:
                if span != "window":
                    open_span = span if what == "enter" else None
                    if what == "enter":
                        spans.setdefault(span, {"device_s": 0.0, "count": 0})["count"] += 1
            done = index[op] + 1
            continue
        if s < t_begin or s > t_end:
            continue
        e = min(e, t_end)
        dur = (e - s) / 1e9
        if open_span is not None:
            spans[open_span]["device_s"] += dur
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + dur
        if s > cur_end:
            gaps.append(((s - cur_end) / 1e9,
                         f"{open_span or 'outside spans'}: after {prev_name[:50]} "
                         f"before {name[:50]}"))
        if e > cur_end:
            busy += e - max(s, cur_end)
            cur_end = e
            prev_name = name
    if t_end > cur_end:
        gaps.append(((t_end - cur_end) / 1e9, f"window end: after {prev_name[:50]}"))
    gaps.sort(key=lambda g: -g[0])
    top_ops = sorted(by_group.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t_end - t_begin) / 1e9, "busy_s": busy / 1e9,
            "lost_marks": len(marks) - len(markers), "spans": spans,
            "device_ops": [[k, v] for k, v in top_ops],
            "idle_gaps": [[label, s] for s, label in gaps[:TOP]]}
