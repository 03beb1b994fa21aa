"""QuantConfig: the quantization options object.

Field for field the JAX package's ``QuantConfig``, so a
``quantization_config.json`` written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from .formats import ACCEPTED_MATMUL_DTYPES, ACCEPTED_WEIGHT_DTYPES, get_format

__all__ = ["QuantConfig"]


def _env_field(name, default, conv=int):
    from .envconfig import env_str
    return dataclasses.field(
        default_factory=lambda: (conv(env_str(name))
                                 if env_str(name) is not None else default))


@dataclasses.dataclass
class QuantConfig:
    weights_dtype: str = "int8"
    quantized_matmul_dtype: str | None = None
    hadamard_group_size: int = _env_field("SDNQ_TPU_HADAMARD_GROUP_SIZE", 256)
    group_size: int = _env_field("SDNQ_TPU_GROUP_SIZE", 0)
    svd_rank: int = _env_field("SDNQ_TPU_SVD_RANK", 32)
    svd_steps: int = _env_field("SDNQ_TPU_SVD_STEPS", 8)
    dynamic_loss_threshold: float | None = _env_field(
        "SDNQ_TPU_DYNAMIC_THRESHOLD", None, float)
    use_svd: bool = False
    use_hadamard: bool = False
    use_grad_ckpt: bool = True
    quant_conv: bool = False
    quant_embedding: bool = False
    use_quantized_matmul: bool = False
    use_quantized_matmul_conv: bool = False
    use_static_quantization: bool = True
    use_dynamic_quantization: bool = False
    use_stochastic_rounding: bool = _env_field(
        "SDNQ_TPU_STOCHASTIC_ROUNDING", False,
        lambda v: v.lower() in ("1", "true", "yes", "on"))
    dequantize_fp32: bool = True
    add_skip_keys: bool = True
    minimum_allowed_numel: int = 16384
    minimum_allowed_channel_size: int = 32
    modules_to_not_convert: list[str] = dataclasses.field(default_factory=list)
    modules_to_not_use_matmul: list[str] = dataclasses.field(
        default_factory=list)
    modules_dtype_dict: dict[str, list[str]] = dataclasses.field(
        default_factory=dict)
    modules_quant_config: dict[str, dict] = dataclasses.field(
        default_factory=dict)
    is_training: bool = False
    sdnq_version: str | None = None
    dequant_dtype: str = _env_field(
        "SDNQ_TPU_DEQUANT_DTYPE", "bfloat16", str)
    quant_method: str = "sdnq"

    def __post_init__(self):
        if self.weights_dtype not in ACCEPTED_WEIGHT_DTYPES:
            raise ValueError(
                f"unsupported weights_dtype {self.weights_dtype!r}")
        if (self.quantized_matmul_dtype is not None
                and self.quantized_matmul_dtype not in ACCEPTED_MATMUL_DTYPES):
            raise ValueError(
                f"unsupported quantized_matmul_dtype "
                f"{self.quantized_matmul_dtype!r} (accepted: "
                f"{sorted(ACCEPTED_MATMUL_DTYPES)})")
        get_format(self.weights_dtype)  # raises on unknown
        if self.is_training:
            self.quant_method = "sdnq_training"

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        from . import __version__
        if d.get("sdnq_version") is None:
            d["sdnq_version"] = __version__
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "QuantConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in d.items() if k in known}
        for key in ("modules_to_not_convert", "modules_to_not_use_matmul"):
            if kept.get(key) is None:
                kept[key] = []
        for key in ("modules_dtype_dict", "modules_quant_config"):
            if kept.get(key) is None:
                kept[key] = {}
        return cls(**kept)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "QuantConfig":
        return cls.from_dict(json.loads(s))
