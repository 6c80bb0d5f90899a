"""Plain PyTorch ops of the STEREO_GIF and STEREO_SGBM paths, rectification
and depth; each keeps the JAX package's module name and term order, and
this package exports what the JAX package's `ops` exports."""

from primestereomatch_torch.ops.boxfilter import box_mean, box_sum, window_sum_1d  # noqa: F401
from primestereomatch_torch.ops.resize import (  # noqa: F401
    nearest_indices,
    resize_nearest,
    resize_bilinear,
)
from primestereomatch_torch.ops.color import bgr_to_gray_refquirk, sobel_x_k1  # noqa: F401
from primestereomatch_torch.ops.cost_volume import build_cost_volumes  # noqa: F401
from primestereomatch_torch.ops.guided_filter import (  # noqa: F401
    fast_guided_filter_color,
    guided_filter_color,
)
from primestereomatch_torch.ops.wta import wta_disparity  # noqa: F401
from primestereomatch_torch.ops.jointwmf import (  # noqa: F401
    feature_weight_table,
    from32f_to_32s,
    from32s_to_32f,
    joint_wmf,
    joint_wmf_float,
)
from primestereomatch_torch.ops.postproc import (  # noqa: F401
    lr_check,
    fill_invalid,
    weighted_median,
)
from primestereomatch_torch.ops.sgbm import (  # noqa: F401
    DISP_SCALE,
    aggregate,
    block_cost,
    bt_block_cost,
    select_disparity_hdw,
    clipped_xderiv,
    filter_speckles,
    select_disparity,
)
from primestereomatch_torch.ops.depth import (  # noqa: F401
    disparity_to_depth,
    reproject_disparity,
)
from primestereomatch_torch.ops.remap import remap_bilinear  # noqa: F401
