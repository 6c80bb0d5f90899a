"""Static pipeline configuration (own copy of primestereomatch_tpu/config.py).

The engine has no learned weights: a `GIFConfig` is its whole state.
`from_jax_config` carries a JAX-package config across as a plain dict
(`dataclasses.asdict(jax_cfg)`), so this package never imports the JAX one.

Unlike the JAX config, unknown values of the implementation selectors are
rejected here instead of silently running a default path. The selectors
name TPU implementations that all compute the same function up to
last-ulp argmin ties; the port has one implementation of that function,
so the accepted values do not change what it runs.
"""

from __future__ import annotations

import dataclasses

_CHOICES = {
    "tail_fusion": ("maps", "full"),
    "cvc_impl": ("auto", "xla", "fused"),
    "wta_impl": ("auto", "xla", "pallas"),
    "wmf_impl": ("auto", "jnp", "pallas"),
    "upsample_impl": ("auto", "lerp", "mxu"),
    "cvc_dtype": ("f32", "u8"),
    "wmf_mode": ("exact", "table"),
}

# valid values this package does not run yet (see ROADMAP.md)
_NOT_PORTED = {
    "cvc_dtype": "u8",
    "wmf_mode": "table",
    "pp_toolchain": True,
}


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
    wmf_n_feat: int = 256
    wmf_mode: str = "exact"
    wmf_impl: str = "auto"
    upsample_impl: str = "auto"
    wta_impl: str = "auto"
    cvc_impl: str = "auto"
    tail_fusion: str = "maps"
    cvc_dtype: str = "f32"
    wta_d_chunk: int = 32
    sig_clr: float = 0.1
    sig_dis: float = 9.0
    pp_toolchain: bool = False

    def __post_init__(self):
        for field, allowed in _CHOICES.items():
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(
                    f"GIFConfig.{field}={value!r} is not one of {allowed}"
                )
        for field, value in _NOT_PORTED.items():
            if getattr(self, field) == value:
                raise NotImplementedError(
                    f"GIFConfig.{field}={value!r} is not ported to "
                    "primestereomatch_torch yet"
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
class EvalConfig:
    """Ground-truth %BP evaluation parameters."""

    error_threshold: int = 4
    max_dis: int = 64
    scale_factor: int = 4

    @property
    def threshold_value(self) -> int:
        # error_threshold * (CHAR_MAX / maxDis) in C integer arithmetic
        return self.error_threshold * (127 // self.max_dis)


def from_jax_config(fields: dict) -> GIFConfig:
    """Build the port's GIFConfig from `dataclasses.asdict()` of the JAX
    package's GIFConfig. Raises on keys this config does not know."""
    known = {f.name for f in dataclasses.fields(GIFConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown GIFConfig keys: {unknown}")
    return GIFConfig(**fields)
