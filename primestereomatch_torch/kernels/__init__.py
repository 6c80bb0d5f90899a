"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version. Nothing is built or loaded at import time."""

from primestereomatch_torch.kernels._build import (  # noqa: F401
    LAUNCHES,
    build,
    reset_launches,
)
from primestereomatch_torch.kernels.lowmaps import (  # noqa: F401
    fgf_low_maps_batched,
    low_maps,
    low_maps_plain,
)
from primestereomatch_torch.kernels.wmf import (  # noqa: F401
    weighted_median,
    weighted_median_plain,
)
from primestereomatch_torch.kernels.wta import (  # noqa: F401
    upsample_wta,
    upsample_wta_plain,
)
