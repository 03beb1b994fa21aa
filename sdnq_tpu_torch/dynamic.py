"""Dynamic per-layer format selection.

The JAX package's ``dynamic``: walk the accuracy-ordered format ladder
(``formats.WEIGHTS_DTYPE_ORDER``) upward from the requested format until the
normalized quantization loss ``mean((dequant(quant(W)) - W)^2) / var(W)``
is at most the threshold, ``10^(-bits/2)`` of the requested format unless
one is given; None when no format passes (the layer stays unquantized).
The Hadamard rotation and the SVD residual are computed once and reused on
every rung.  The ladder runs eagerly on the weight's device, and the
resulting tree holds layers of different formats, each taking its own
kernel mode.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import QuantConfig
from .formats import (
    WEIGHTS_DTYPE_ORDER, default_matmul_format, get_format, resolve_alias,
    torch_dtype,
)
from .tensor import QTensor, dequantize, quantize_tensor

__all__ = ["quantize_tensor_dynamic", "quantization_loss"]


def quantization_loss(w: torch.Tensor, qt: QTensor) -> float:
    """Normalized MSE of the round trip, ``mean((deq - w)^2) / max(var(w),
    1e-8)`` (population variance).  In float64 on the CPU.  On the card in
    fp32, each mean as one ``torch.mean`` over the flattened tensor (the
    plain reduction, the same order whatever the layer), so a layer's
    choice does not hinge on a summation order of its own."""
    deq = dequantize(qt, dtype=torch.float32)
    acc = torch.float64 if w.device.type == "cpu" else torch.float32
    w = w.to(acc).reshape(-1)
    var = torch.clamp_min(torch.var(w, correction=0), 1e-8)
    return float(torch.mean(torch.square(deq.to(acc).reshape(-1) - w))
                 / var)


def _matmul_combo_valid(weights_fmt: str, matmul_fmt: str,
                        requested_fmt: str) -> bool:
    """Whether a rung's storage format may feed the matmul format (the
    reference's compatibility rules)."""
    wf, mf = get_format(weights_fmt), get_format(matmul_fmt)
    rf = get_format(requested_fmt)
    if mf.is_integer and not wf.is_integer:
        return False
    if wf.num_bits == mf.num_bits and wf.is_unsigned and not mf.is_integer:
        return False
    if rf.num_bits <= mf.num_bits and wf.num_bits > mf.num_bits:
        return False
    return True


def quantize_tensor_dynamic(w: torch.Tensor, layer_kind: str = "linear", *,
                            fmt: str = "uint4", matmul_fmt: str | None = None,
                            dynamic_loss_threshold: float | None = None,
                            config: QuantConfig | None = None,
                            param_name: str | None = None,
                            generator: torch.Generator | None = None,
                            **kwargs) -> QTensor | None:
    """The first QTensor up the ladder from ``fmt`` whose loss is within
    the threshold, or None.  Under ``use_quantized_matmul`` a rung whose
    format cannot feed its matmul format is stored weight-only, and
    ``param_name`` joins ``config.modules_to_not_use_matmul``."""
    start = resolve_alias(fmt)
    if dynamic_loss_threshold is None or dynamic_loss_threshold < 0:
        dynamic_loss_threshold = 10.0 ** -(get_format(start).num_bits / 2)
    w32 = w.float()
    use_quantized_matmul = kwargs.pop("use_quantized_matmul", False)
    use_hadamard = kwargs.pop("use_hadamard", False)
    use_svd = kwargs.pop("use_svd", False)
    hadamard_group_size = kwargs.pop("hadamard_group_size", 256)
    svd_rank = kwargs.pop("svd_rank", 32)
    svd_steps = kwargs.pop("svd_steps", 8)

    pre, up, down = w32, None, None
    if use_hadamard:
        from .quant.hadamard import apply_hadamard
        pre, use_hadamard, hadamard_group_size = apply_hadamard(
            pre, hadamard_group_size,
            is_conv=layer_kind == "conv" and pre.dim() > 2)
    if use_svd and pre.dim() >= 2 and layer_kind != "conv_transpose":
        from .quant.svd import apply_svdquant
        dd = torch_dtype(kwargs.get("dequant_dtype", "bfloat16"))
        pre, up, down = apply_svdquant(pre, rank=svd_rank, niter=svd_steps,
                                       generator=generator)
        up, down = up.to(dd), down.to(dd)

    try:
        start_idx = WEIGHTS_DTYPE_ORDER.index(start)
    except ValueError:
        start_idx = 0
    for name in WEIGHTS_DTYPE_ORDER[start_idx:]:
        mm = matmul_fmt or default_matmul_format(name)
        cur_use_mm = use_quantized_matmul and _matmul_combo_valid(
            name, mm, start)
        qt = quantize_tensor(
            pre, name, layer_kind, matmul_fmt=mm,
            use_quantized_matmul=cur_use_mm, use_hadamard=False,
            use_svd=False, svd_precomputed=up is not None,
            hadamard_group_size=hadamard_group_size, svd_rank=svd_rank,
            svd_steps=svd_steps, generator=generator, **kwargs)
        if up is not None or use_hadamard:
            qt = dataclasses.replace(qt, svd_up=up, svd_down=down,
                                     meta=dataclasses.replace(
                                         qt.meta,
                                         use_hadamard=bool(use_hadamard),
                                         hadamard_group_size=(
                                             hadamard_group_size),
                                         svd_rank=(svd_rank if up is not None
                                                   else 0)))
        if quantization_loss(w32, qt) <= dynamic_loss_threshold:
            if (config is not None and param_name is not None
                    and use_quantized_matmul and not cur_use_mm
                    and param_name not in config.modules_to_not_use_matmul):
                config.modules_to_not_use_matmul.append(param_name)
            return qt
    return None
