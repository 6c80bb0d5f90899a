from primestereomatch_torch.models.gif_pipeline import (  # noqa: F401
    StereoGIF,
    stereo_gif_forward,
)
