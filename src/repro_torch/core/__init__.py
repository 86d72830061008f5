"""PQ math, table quantization, the LUT linear layer and the replacement
plan; exports `repro.core`'s names."""

from repro_torch.core.amm import (
    LUTConfig,
    Mode,
    dense_bytes,
    dense_flops,
    lut_flops,
    lut_linear,
    lut_table_bytes,
)
from repro_torch.core.lut_layer import (
    deploy_param_specs,
    deploy_params,
    init_dense,
    lut_train_params_from_dense,
)
from repro_torch.core.plan import (
    PAPER_DEFAULT,
    LUTPlan,
    PlanRule,
    SitePolicy,
    SiteSelector,
    SiteSpec,
    rule,
)

__all__ = [
    "LUTConfig",
    "LUTPlan",
    "Mode",
    "PAPER_DEFAULT",
    "PlanRule",
    "SitePolicy",
    "SiteSelector",
    "SiteSpec",
    "rule",
    "lut_linear",
    "lut_flops",
    "dense_flops",
    "lut_table_bytes",
    "dense_bytes",
    "init_dense",
    "lut_train_params_from_dense",
    "deploy_params",
    "deploy_param_specs",
]
