"""Multi-device STEREO_GIF and STEREO_SGBM over torch.distributed: the
(b, y, d) mesh (`mesh.py`), the sharded steps (`sharded.py`) and the
multi-process launcher (`launch.py`)."""

from primestereomatch_torch.parallel.mesh import (  # noqa: F401
    MeshPlan,
    factor_devices,
    make_mesh,
)
from primestereomatch_torch.parallel.sharded import (  # noqa: F401
    halo_exchange_rows,
    make_sharded_gif,
    make_sharded_sgbm,
)
