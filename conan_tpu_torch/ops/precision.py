"""The exact / high / fast serving ladder (``conan_tpu/infer/streaming.py:183-188``)
and the default / high / highest training rungs, as torch settings.

  exact  fp32 everywhere: TF32 off for matmuls AND cuDNN convs (cuDNN's own
         default is TF32 on, which breaks streaming ≡ offline).
  high   TF32 for matmuls and convs.
  fast   bf16 autocast (plus TF32 for what autocast leaves in fp32).

The engine runs the Emformer under ``exact`` on every rung (its argmax codes are
the one discrete step) and only the acoustic model and vocoder under the
chosen rung.

Training reads ``train_precision`` (``conan_tpu/ops/precision.py``, one
scope around the whole run in the JAX package) through ``training_scope``:

  highest  ``exact``: fp32, TF32 off for matmuls and cuDNN convs.
  high     the serving ladder's ``high``: TF32 for matmuls and convs (JAX's
           bf16x3 on the TPU is more exact than TF32).
  default  JAX's DEFAULT: every dot and conv takes bf16-rounded operands,
           accumulates in fp32 and returns fp32; every other op (elementwise,
           norms, softmax, losses, the VQ EMA, the master weights and AdamW
           state, the NaN guard) stays fp32 with TF32 off. The dot and conv
           call sites ask ``bf16_dots()`` at call time, as JAX's ops read
           ``get_precision()``: the dense and grouped conv1d run their own
           kernels (``ops/denseconv.py``, ``ops/groupconv.py``) or
           ``rounded_dot``, the others ``bf16_dot``. No autocast: it
           would hand bf16 activations on to the leaky ReLUs, residual adds
           and L1 losses, which JAX's DEFAULT keeps in fp32.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("exact", "high", "fast")


@contextlib.contextmanager
def precision_scope(name: str, device: torch.device):
    """Set the rung ``name`` for the ops run inside the block on ``device``,
    and restore the previous global TF32 flags afterwards."""
    if name not in PRECISIONS:
        raise ValueError(f"serving precision {name!r} not in {PRECISIONS}")
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    old = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = name != "exact"
    try:
        if name == "fast":
            with torch.autocast(device_type=device.type, dtype=torch.bfloat16):
                yield
        else:
            yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = old


TRAINING_RUNGS = ("default", "high", "highest")
_SERVING_OF = {"highest": "exact", "high": "high", "default": "exact"}
_bf16_dots = False


def bf16_dots() -> bool:
    """True inside ``training_scope("default")``: the dot and conv call sites
    then run through ``bf16_dot``. Read at call time."""
    return _bf16_dots


@contextlib.contextmanager
def training_scope(name: str, device: torch.device):
    """Train at rung ``name`` (``TRAINING_RUNGS``) inside the block on
    ``device``: the TF32 flags of its serving rung (``_SERVING_OF``), and for
    "default" the bf16 dots. Restores both afterwards."""
    global _bf16_dots
    if name not in TRAINING_RUNGS:
        raise ValueError(f"train_precision {name!r} not in {TRAINING_RUNGS}")
    old = _bf16_dots
    _bf16_dots = name == "default"
    try:
        with precision_scope(_SERVING_OF[name], device):
            yield
    finally:
        _bf16_dots = old


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the backward rounds the incoming gradient to
    bf16, the operand rounding of the dots that carry it back."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class _Round(torch.autograd.Function):
    """Round to bf16 and back to the input's type; the gradient passes as it
    is (the dot that takes the rounded operand rounds its own gradient
    operands)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def bf16_dot(fn, *operands: torch.Tensor) -> torch.Tensor:
    """``fn(*operands)``, a dot or conv without bias, at the "default" rung:
    bf16-rounded operands, fp32 accumulation, an fp32 result, and the same
    for its backward dots (their gradient operand rounded too).

    On the card the operands go to ``fn`` as bf16 tensors, so cuBLAS and
    cuDNN run their bf16 tensor-core kernels; these return bf16, cast back to
    fp32 at once: one rounding of each result (forward, dx and dw) that JAX's
    DEFAULT, with its fp32 output, does not make. On the CPU ``fn`` runs in
    fp32 on the rounded values, which is exactly the fp32 product of
    bf16-rounded operands, with no extra rounding (its bf16 kernels round
    their output too, and are slow)."""
    if operands[0].device.type == "cpu":
        return rounded_dot(fn, *operands)
    return fn(*(t.to(torch.bfloat16) for t in operands)).float()


def rounded_dot(fn, *operands: torch.Tensor) -> torch.Tensor:
    """``fn(*operands)`` in fp32 on bf16-rounded operands, its backward with
    the incoming gradient rounded too: JAX's DEFAULT exactly, on any device.
    ``bf16_dot``'s CPU route, and the plain version the card's bf16 route is
    held to."""
    return _RoundGrad.apply(fn(*(_Round.apply(t) for t in operands)))


def dot_at_rung(fn, *operands: torch.Tensor) -> torch.Tensor:
    """``fn(*operands)`` (a dot or conv without bias) through ``bf16_dot``
    under the "default" rung, else as it is."""
    return bf16_dot(fn, *operands) if _bf16_dots else fn(*operands)
