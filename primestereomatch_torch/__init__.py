"""primestereomatch_torch: the stereo engine (STEREO_GIF and STEREO_SGBM) on
PyTorch and hand-written CUDA kernels for an NVIDIA H100 (Hopper, sm_90a).

A port of primestereomatch_tpu, kept beside it; it imports nothing of that
package. Entry points run on the CUDA card unless the caller passes
device="cpu", which runs each kernel's plain PyTorch version.
"""

import torch

from primestereomatch_torch.config import (  # noqa: F401
    EvalConfig,
    GIFConfig,
    SGBMConfig,
    from_jax_config,
    from_jax_sgbm_config,
)
from primestereomatch_torch.models import (  # noqa: F401
    StereoGIF,
    StereoSGBM,
    sgbm_display_u8,
    stereo_gif_forward,
    stereo_gif_forward_batch,
    stereo_sgbm_forward,
)

__version__ = "0.1.0"

# An argmin sits downstream of every float stage, so no stage may run in
# TF32: it keeps about three decimal digits and would move argmin ties
# (the JAX package needs HIGHEST matmul precision for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
