"""Static pipeline configuration (own copy of primestereomatch_tpu/config.py).

The engine has no learned weights: a `GIFConfig` or `SGBMConfig` is its
whole state. `from_jax_config` and `from_jax_sgbm_config` carry a
JAX-package config across as a plain dict (`dataclasses.asdict(jax_cfg)`),
so this package never imports the JAX one.

The configs hold only the fields the port reads. The JAX configs also
carry implementation selectors that choose between TPU implementations of
one function (Pallas kernel or XLA); the port has one implementation, so
it has no such fields. The two converters still check each selector
against the values the JAX package allows (an unknown value raises), then
drop it. `tail_fusion` is not such a selector: it chooses what a frame
costs in device memory, and the port keeps it.
"""

from __future__ import annotations

import dataclasses

_CHOICES = {
    "tail_fusion": ("maps", "full"),
    "cvc_dtype": ("f32", "u8"),
    "wmf_mode": ("exact", "table"),
}

# the JAX configs' TPU implementation selectors and their allowed values;
# `from_jax_*` validate and drop them
_JAX_GIF_SELECTORS = {
    "cvc_impl": ("auto", "xla", "fused"),
    "wta_impl": ("auto", "xla", "pallas"),
    "wmf_impl": ("auto", "jnp", "pallas"),
    "upsample_impl": ("auto", "lerp", "mxu"),
    # the TPU sweep's d-chunk depth: any positive int
    "wta_d_chunk": lambda v: isinstance(v, int) and v >= 1,
}
_JAX_SGBM_SELECTORS = {
    "agg_impl": ("auto", "xla", "pallas"),
}

SGBM_DIRECTIONS = {"hh": 8, "sgbm": 5, "3way": 3}


@dataclasses.dataclass(frozen=True)
class GIFConfig:
    """STEREO_GIF pipeline parameters; defaults reproduce the reference
    golden path: CVC no-clamp -> FastGuidedFilter s=4 -> WTA d>=1 ->
    JointWMF r=9."""

    max_dis: int = 64
    alpha: float = 0.9
    border_cost: float = 1.0
    tau1: float | None = None    # None = no clamp (CPU float semantics)
    tau2: float | None = None
    grad_offset: float = 0.0     # 0.5 = OpenCL-variant gradient offset
    gif_radius: int = 8
    gif_eps: float = 1e-4
    subsample: int = 4
    med_sz: int = 19             # JointWMF radius = med_sz // 2
    wmf_sigma: float = 25.5
    wmf_n_feat: int = 256        # feature clusters of 'table' mode (utils/features.py)
    # JointWMF weights: 'exact' from the 6-bit colours (K3); 'table' from a
    # per-pixel feature index and an (nF, nF) table, when the caller passes
    # them (stereo_gif_forward's l_findex, r_findex, wmap)
    wmf_mode: str = "exact"
    # 'u8': the reference's uchar OpenCL cost (integer /3, uint8 cost),
    # fed to the FGF at /255 scale; it always takes K1 -> K2
    cvc_dtype: str = "f32"
    # 'maps': the coefficient maps (4, D, h, w) per view go through device
    # memory between the low-maps and the WTA kernel. 'full': at
    # exact-stride, phase-periodic geometries (ops/geometry.py) cost, chain
    # and WTA run in one kernel and neither the cost volume nor the maps
    # exist in device memory; other geometries take the maps path.
    tail_fusion: str = "maps"    # maps | full
    sig_clr: float = 0.1         # wgtMedian colour sigma (ops/postproc.py)
    sig_dis: float = 9.0         # wgtMedian distance sigma
    # lrCheck -> fillInv -> wgtMedian ahead of JointWMF (the reference
    # ships it commented out, src/PP.cpp:405-413)
    pp_toolchain: bool = False

    def __post_init__(self):
        for field, allowed in _CHOICES.items():
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(
                    f"GIFConfig.{field}={value!r} is not one of {allowed}"
                )
        # disparities are stored as uint8 and d=0 is never selected
        if not 2 <= self.max_dis <= 256:
            raise ValueError(f"max_dis must be in [2, 256], got {self.max_dis}")
        if self.subsample < 1 or self.gif_radius < 0:
            raise ValueError("subsample must be >= 1 and gif_radius >= 0")

    @property
    def fgf_low_radius(self) -> int:
        # 2*(r/s)+1 with C integer division (src/fastguidedfilter.cpp:206-208)
        return 2 * (self.gif_radius // self.subsample) + 1

    @property
    def wmf_radius(self) -> int:
        return self.med_sz // 2


@dataclasses.dataclass(frozen=True)
class SGBMConfig:
    """STEREO_SGBM parameters (reference: src/StereoMatch.cpp:639-660).
    `num_channels` is the channel count of the images the penalties were
    chosen for; `stereo_sgbm_forward` checks its inputs against it."""

    min_disparity: int = 0
    num_disparities: int = 64
    block_size: int = 5
    p1: int = 8 * 3 * 25         # 8 * channels * SADWindowSize^2
    p2: int = 32 * 3 * 25
    disp12_max_diff: int = 1
    pre_filter_cap: int = 63
    uniqueness_ratio: int = 10
    speckle_window_size: int = 100
    speckle_range: int = 32
    mode: str = "hh"             # hh | sgbm | 3way ('m' key cycle, main.cpp:161-163)
    num_channels: int = 3

    def __post_init__(self):
        if self.mode not in SGBM_DIRECTIONS:
            raise ValueError(
                f"unknown SGBM mode {self.mode!r}; one of {tuple(SGBM_DIRECTIONS)}"
            )
        if self.num_disparities < 1 or self.block_size < 1 or self.num_channels < 1:
            raise ValueError(
                "num_disparities, block_size and num_channels must be >= 1"
            )
        if self.pre_filter_cap < 0:
            raise ValueError(f"pre_filter_cap must be >= 0, got {self.pre_filter_cap}")

    @property
    def num_directions(self) -> int:
        """MODE_HH = 8 directions, MODE_SGBM = the causal 5,
        MODE_SGBM_3WAY = {W->E, E->W, N->S}."""
        return SGBM_DIRECTIONS[self.mode]


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Ground-truth %BP evaluation parameters."""

    error_threshold: int = 4
    max_dis: int = 64
    scale_factor: int = 4

    @property
    def threshold_value(self) -> int:
        # error_threshold * (CHAR_MAX / maxDis) in C integer arithmetic
        return self.error_threshold * (127 // self.max_dis)


def _from_jax(cls, fields: dict, selectors: dict):
    fields = dict(fields)
    for key, allowed in selectors.items():
        if key not in fields:
            continue
        value = fields.pop(key)
        if not (allowed(value) if callable(allowed) else value in allowed):
            raise ValueError(f"JAX {cls.__name__}.{key}={value!r} is not allowed")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {unknown}")
    return cls(**fields)


def from_jax_config(fields: dict) -> GIFConfig:
    """Build the port's GIFConfig from `dataclasses.asdict()` of the JAX
    package's GIFConfig. Every field the port reads comes across
    (`tail_fusion`, `cvc_dtype`, `wmf_mode`, `pp_toolchain`, `wmf_n_feat`,
    `sig_clr` and `sig_dis` among them); the TPU selectors and
    `wta_d_chunk` are checked and dropped; other keys this config does not
    know raise."""
    return _from_jax(GIFConfig, fields, _JAX_GIF_SELECTORS)


def from_jax_sgbm_config(fields: dict) -> SGBMConfig:
    """Build the port's SGBMConfig from `dataclasses.asdict()` of the JAX
    package's SGBMConfig. `agg_impl` is checked and dropped; other keys
    this config does not know raise."""
    return _from_jax(SGBMConfig, fields, _JAX_SGBM_SELECTORS)
