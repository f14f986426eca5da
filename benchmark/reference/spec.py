"""CoTracker3's parameters, by the names of the published state_dict.

`param_spec` lists every parameter of CoTracker3 at the given widths as
(name, shape, fan_in, role). The published checkpoint names the virtual
tracks `updateformer.virual_tracks`; the port and this list call them
`updateformer.virtual_tracks`. Roles: "weight" and "bias" of a layer whose
fan-in is given, "norm_weight" / "norm_bias" of an affine LayerNorm,
"virtual" for the virtual track tokens, "head" / "head_bias" for the flow
and vis/conf heads.
"""


def _linear(name, n_out, n_in):
    return [(f"{name}.weight", (n_out, n_in), n_in, "weight"),
            (f"{name}.bias", (n_out,), n_in, "bias")]


def _conv(name, n_out, n_in, k):
    return [(f"{name}.weight", (n_out, n_in, k, k), n_in * k * k, "weight"),
            (f"{name}.bias", (n_out,), n_in * k * k, "bias")]


def _residual(name, n_in, planes, stride):
    out = _conv(f"{name}.conv1", planes, n_in, 3) + _conv(f"{name}.conv2", planes, planes, 3)
    if stride != 1:
        out += _conv(f"{name}.downsample.0", planes, n_in, 1)
    return out


def _attn_block(name, hidden, mlp_hidden):
    return (_linear(f"{name}.attn.to_q", hidden, hidden)
            + _linear(f"{name}.attn.to_kv", 2 * hidden, hidden)
            + _linear(f"{name}.attn.to_out", hidden, hidden)
            + _linear(f"{name}.mlp.fc1", mlp_hidden, hidden)
            + _linear(f"{name}.mlp.fc2", hidden, mlp_hidden))


def _cross_block(name, hidden, mlp_hidden):
    return ([(f"{name}.norm_context.weight", (hidden,), hidden, "norm_weight"),
             (f"{name}.norm_context.bias", (hidden,), hidden, "norm_bias")]
            + _linear(f"{name}.cross_attn.to_q", hidden, hidden)
            + _linear(f"{name}.cross_attn.to_kv", 2 * hidden, hidden)
            + _linear(f"{name}.cross_attn.to_out", hidden, hidden)
            + _linear(f"{name}.mlp.fc1", mlp_hidden, hidden)
            + _linear(f"{name}.mlp.fc2", hidden, mlp_hidden))


def param_spec(cfg):
    """Every parameter of CoTracker3 at the widths of configuration `cfg`
    (the keys of a benchmark configuration file)."""
    d = cfg["latent_dim"]
    hidden, heads = cfg["hidden_size"], cfg["num_heads"]
    mlp_hidden = int(hidden * cfg["mlp_ratio"])
    P = 2 * cfg["corr_radius"] + 1
    corr_in = P**4
    input_dim = 2 + cfg["corr_levels"] * cfg["corr_hidden_out"] + cfg["rel_posenc_dim"]
    assert hidden % heads == 0
    spec = _conv("fnet.conv1", d // 2, 3, 7)
    widths = [(d // 2, d // 2, 1), (d // 2, d // 4 * 3, 2), (d // 4 * 3, d, 2), (d, d, 2)]
    for i, (n_in, planes, stride) in enumerate(widths, start=1):
        spec += _residual(f"fnet.layer{i}.0", n_in, planes, stride)
        spec += _residual(f"fnet.layer{i}.1", planes, planes, 1)
    spec += _conv("fnet.conv2", 2 * d, d * 3 + d // 4, 3) + _conv("fnet.conv3", d, 2 * d, 1)
    spec += _linear("corr_mlp.fc1", cfg["corr_hidden"], corr_in)
    spec += _linear("corr_mlp.fc2", cfg["corr_hidden_out"], cfg["corr_hidden"])
    uf = "updateformer"
    spec += _linear(f"{uf}.input_transform", hidden, input_dim)
    spec.append((f"{uf}.virtual_tracks", (1, cfg["num_virtual_tracks"], 1, hidden), hidden,
                 "virtual"))
    for i in range(cfg["time_depth"]):
        spec += _attn_block(f"{uf}.time_blocks.{i}", hidden, mlp_hidden)
    for i in range(cfg["space_depth"]):
        spec += _attn_block(f"{uf}.space_virtual_blocks.{i}", hidden, mlp_hidden)
    for kind in ("space_point2virtual_blocks", "space_virtual2point_blocks"):
        for i in range(cfg["space_depth"]):
            spec += _cross_block(f"{uf}.{kind}.{i}", hidden, mlp_hidden)
    for name, n_out in (("flow_head", 2), ("vis_conf_head", 2)):
        spec += [(f"{uf}.{name}.weight", (n_out, hidden), hidden, "head"),
                 (f"{uf}.{name}.bias", (n_out,), hidden, "head_bias")]
    return spec
