"""Entry points: STEREO_GIF (single frame, batch, module) and STEREO_SGBM."""

from primestereomatch_torch.models.gif_pipeline import (  # noqa: F401
    StereoGIF,
    stereo_gif_forward,
    stereo_gif_forward_batch,
)
from primestereomatch_torch.models.sgbm_pipeline import (  # noqa: F401
    StereoSGBM,
    sgbm_display_u8,
    stereo_sgbm_forward,
)
