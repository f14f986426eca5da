"""The four kernel-variant switches of the JAX package, as one immutable
record that the model passes down to its blocks and kernel wrappers.

    corr_fuse_mlp1   K4m instead of K4 + the int8 MLP1 product: the
                     correlation kernel also combines, quantizes per point
                     and applies MLP1 + b1 (COTRACKER_CORR_FUSE_MLP1)
    space_allt       K11 instead of the K2 chain for the points<-virtual
                     block where the JAX all-frames gate holds
                     (COTRACKER_SPACE_ALLT)
    bf16_ln          the W8A8 bodies' LayerNorm statistics in bf16
                     (COTRACKER_BF16_LN)
    gelu_quant_fold  the GELU codes' row scale from the pre-GELU row max
                     (COTRACKER_GELU_QUANT_FOLD)

The JAX package reads the four environment variables at trace time, inside
its kernel wrappers. The port resolves them once, when the model is built
(`KernelVariants.from_env()` in `build_cotracker` and the predictors), and
explicit arguments override the environment. All four default to off, as
in JAX. `bf16_ln` and `gelu_quant_fold` change the function of every W8A8
body (K1, the K2 chain, K8, K9, K10, K11, K12) in its plain version and
its kernel alike; K3's affine LayerNorm and the attention cores K5-K7 do
not change. The ablation and debug knobs of the JAX package
(`COTRACKER_NO_*`, `COTRACKER_MLP1_ABLATE`, `CORR_FLAT_ACC`,
`COTRACKER_V2P_BLOCK`) are not ported: the ablations give wrong results by
design, the others pick TPU layouts.
"""

import os
from typing import NamedTuple, Optional

ENV = {
    "corr_fuse_mlp1": "COTRACKER_CORR_FUSE_MLP1",
    "space_allt": "COTRACKER_SPACE_ALLT",
    "bf16_ln": "COTRACKER_BF16_LN",
    "gelu_quant_fold": "COTRACKER_GELU_QUANT_FOLD",
}


def mlp1_env(flag: bool) -> bool:
    """corr_pallas._mlp1_env: COTRACKER_CORR_FUSE_MLP1 unset or "" leaves
    `flag`; "0", "false" or "False" turns it off; any other value on."""
    v = os.environ.get(ENV["corr_fuse_mlp1"])
    if v is None or v == "":
        return flag
    return v not in ("0", "false", "False")


class KernelVariants(NamedTuple):
    corr_fuse_mlp1: bool = False
    space_allt: bool = False
    bf16_ln: bool = False
    gelu_quant_fold: bool = False

    @classmethod
    def from_env(cls, corr_fuse_mlp1: Optional[bool] = None, space_allt: Optional[bool] = None,
                 bf16_ln: Optional[bool] = None,
                 gelu_quant_fold: Optional[bool] = None) -> "KernelVariants":
        """The switches as the JAX package would read them from the
        environment now; an argument that is not None overrides its
        variable."""
        env = dict(
            corr_fuse_mlp1=mlp1_env(False),
            space_allt=os.environ.get(ENV["space_allt"], "0") == "1",
            bf16_ln=os.environ.get(ENV["bf16_ln"]) == "1",
            gelu_quant_fold=os.environ.get(ENV["gelu_quant_fold"]) == "1",
        )
        given = dict(corr_fuse_mlp1=corr_fuse_mlp1, space_allt=space_allt, bf16_ln=bf16_ln,
                     gelu_quant_fold=gelu_quant_fold)
        return cls(**{k: env[k] if v is None else bool(v) for k, v in given.items()})


OFF = KernelVariants()
