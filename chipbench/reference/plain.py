"""What the references share: the precision of their matrix products,
the parameter specification the benchmark draws weights from, and small
primitives.

A reference runs in float32 with TF32 off (``strict_float32``).  Its
control runs the same code with every matrix product one step below the
configuration's dtype: for bfloat16, on float8 (e4m3) operands, each
tensor scaled by its own largest magnitude, summed in float32; for
float32, on TF32 operands.

A reference module ``reference/<family>.py`` gives:

    param_specs(cfg) -> [ParamSpec]   every parameter, by the port's names
    logits(P, cfg, ids, prec, positions=None) -> float32 logits
    tiny(cfg) -> cfg      ``derived`` at the tests' tiny sizes, which the
                          tests set in ``model`` from the port's own
    medium(cfg) -> cfg    the CPU size of the control's test

``P`` holds the weights as drawn, in the served dtype: the check keeps 2 B
a bfloat16 parameter on the card.  A reference upcasts each weight to
float32 where it uses it, which is exact, and keeps no float32 copy of
them all.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Sequence, Tuple

import torch

FP8_MAX = 448.0        # largest finite float8 e4m3 value


@contextlib.contextmanager
def strict_float32() -> Iterator[None]:
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, returned in
    float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), returned in float32; infinities and NaNs kept."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    y = (((bits + 0xFFF + lsb) >> 13) << 13).view(torch.float32)
    return torch.where(torch.isfinite(x), y, x)


@dataclass(frozen=True)
class Precision:
    """``float32``, ``tf32`` or ``fp8``: how a reference multiplies
    matrices (TF32: operands rounded to a 10-bit mantissa, products summed
    in float32, as the tensor cores do)."""
    name: str = "float32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a (..., K) @ b (K, N)`` in float32 or on float8 operands."""
        if self.name == "float32":
            return a @ b
        if self.name == "tf32":
            return to_tf32(a) @ to_tf32(b)
        if self.name != "fp8":
            raise ValueError(f"unknown precision {self.name!r}")
        return to_fp8(a) @ to_fp8(b)


FLOAT32 = Precision("float32")
FP8 = Precision("fp8")
TF32 = Precision("tf32")
# the control of each served dtype: the nearest precision below it
CONTROL = {"float32": TF32, "bfloat16": FP8}


@dataclass(frozen=True)
class ParamSpec:
    """One parameter the benchmark draws: its name in the port's module,
    shape, dtype, and ``init``: ``("normal", std)`` or ``("uniform", lo,
    hi)``."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: Tuple


def normal(std: float) -> Tuple:
    return ("normal", float(std))


def uniform(lo: float, hi: float) -> Tuple:
    return ("uniform", float(lo), float(hi))


def fan_in(shape: Sequence[int]) -> Tuple:
    return normal(1.0 / math.sqrt(shape[0]))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def shift(x: torch.Tensor) -> torch.Tensor:
    """Each position's previous token along axis 1, zeros before the
    first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def model_dtype(cfg: Dict) -> torch.dtype:
    """The dtype the configuration serves its weights in."""
    return getattr(torch, cfg["model"].get("dtype", "bfloat16"))
