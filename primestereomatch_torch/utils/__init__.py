from primestereomatch_torch.utils.datasets import (  # noqa: F401
    DATASETS,
    MASK_DISC,
    MASK_NONE,
    MASK_NONOCC,
    StereoSample,
    load_dataset,
)
from primestereomatch_torch.utils.device import resolve_device  # noqa: F401
from primestereomatch_torch.utils.eval import BPResult, bad_pixel_metrics  # noqa: F401
from primestereomatch_torch.utils.features import (  # noqa: F401
    feature_index_color,
    feature_index_gray,
)
from primestereomatch_torch.utils.display import (  # noqa: F401
    build_mosaic,
    disp_to_u8,
    save_png,
)
from primestereomatch_torch.utils.profiling import (  # noqa: F401
    StageTimers,
    span,
    trace,
)
from primestereomatch_torch.utils.video import (  # noqa: F401
    FrameSource,
    PairFileSource,
    SideBySideFileSource,
    SyntheticZEDSource,
    open_source,
)
