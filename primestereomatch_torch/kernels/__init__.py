"""Hand-written CUDA kernels of the main paths, each beside its plain
PyTorch version. Nothing is built or loaded at import time.

STEREO_GIF: K1 low-maps, K2 upsample+WTA (every ratio: it is the TPU's
polyphase kernel and its generic-ratio kernel K5 in one), K3 JointWMF, K4
cost + low-maps (exact-stride geometries), K10 cost + chain + WTA in one
kernel (`tail_fusion='full'`).
STEREO_SGBM: K6 BT cost, K7 SGM scans (uint16 group partials, by two image
sweeps or by path families; or the int32 S), K8 selection (from either), K9
speckle sweep.
"""

from primestereomatch_torch.kernels._build import (  # noqa: F401
    LAUNCHES,
    SWEEPS,
    build,
    reset_launches,
)
from primestereomatch_torch.kernels.cvc_lowmaps import (  # noqa: F401
    cvc_low_maps,
    cvc_low_maps_plain,
)
from primestereomatch_torch.kernels.cvc_wta import (  # noqa: F401
    cvc_wta,
    cvc_wta_plain,
)
from primestereomatch_torch.kernels.lowmaps import (  # noqa: F401
    fgf_low_maps_batched,
    low_maps,
    low_maps_plain,
)
from primestereomatch_torch.kernels.speckle import (  # noqa: F401
    pack_links,
    segmin_sweep,
    segmin_sweep_plain,
    speckle_sweep,
    speckle_sweep_plain,
)
from primestereomatch_torch.kernels.bt_cost import (  # noqa: F401
    bt_cost,
    bt_cost_plain,
)
from primestereomatch_torch.kernels.sgbm_scan import (  # noqa: F401
    partial_groups,
    sgbm_aggregate,
    sgbm_aggregate_partials,
    sgbm_aggregate_partials_plain,
    sgbm_aggregate_plain,
)
from primestereomatch_torch.kernels.select import (  # noqa: F401
    select_disparity,
    select_disparity_partials,
    select_disparity_partials_plain,
    select_disparity_plain,
)
from primestereomatch_torch.kernels.wmf import (  # noqa: F401
    weighted_median,
    weighted_median_plain,
)
from primestereomatch_torch.kernels.wta import (  # noqa: F401
    upsample_wta,
    upsample_wta_plain,
)
