"""Quantization core (port of ``repro/core``): FlexRound and the rounding
baselines, LSQ, QDrop, QTensor export, QuantCtx and the block-wise
reconstruction engine."""
from repro_torch.core.method_api import (  # noqa: F401
    RoundingMethod,
    available_methods,
    get_method,
    register_method,
)
from repro_torch.core.quant_config import (  # noqa: F401
    QuantConfig,
    QuantRecipe,
    SitePlan,
    SiteRule,
)
from repro_torch.core.qtensor import QTensor, dequantize_qtensor  # noqa: F401
from repro_torch.core.context import QuantCtx  # noqa: F401
from repro_torch.core.reconstruct import (  # noqa: F401
    BlockHandle,
    Site,
    quantize_blocks,
    reconstruct_block,
    finalize_block,
)
from repro_torch.core import (  # noqa: F401
    adaquant,
    adaround,
    flexround,
    lsq,
    method_api,
    observers,
    qdrop,
    quantizer,
    rtn,
)
