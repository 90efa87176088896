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
           sums their exact products in fp32 and returns fp32, and so do
           their gradients (the incoming gradient rounded too); every other
           op (elementwise, norms, softmax, losses, the master weights and
           AdamW state, the NaN guard) stays fp32 with TF32 off. The call
           sites ask ``bf16_dots()`` at call time, as JAX's ops read
           ``get_precision()``. No autocast: it would hand bf16 activations
           on to the leaky ReLUs, residual adds and L1 losses, which JAX's
           DEFAULT keeps in fp32.

The JAX package's ``precision=`` sites that read the rung, and the port's
route for each under "default" (CPU: the same route, each product the fp32
op on rounded operands, ``rounded_dot``'s arithmetic):

  ops/conv.py:76 conv1d            dense stride 1: K3 (``ops/denseconv.py``)
                                   where ``dense_kernel_takes``, else
                                   ``rounded_dot`` (fp32 cuDNN, TF32 off);
                                   grouped: K2-bf16 (``ops/groupconv.py``)
  ops/conv.py:143 conv_transpose1d K3 over ``ConvTranspose1dFold`` (one
                                   stride-1 conv1d, ``ops/conv.py``) where
                                   ``dense_kernel_takes`` it, else
                                   ``rounded_dot``
  ops/conv.py:167 conv2d           K3 over ``Conv2dFold`` (one dilated
                                   conv1d) where ``dense_kernel_takes`` it,
                                   else ``rounded_dot``
  nn/blocks.py:48 dense, :417-419  ``dot_at_rung`` (``nn/blocks.py:dense``)
  nn/blocks.py:426, :433           ``einsum_at_rung`` (the aligner's MHA)
  models/emformer.py:86            ``dot_at_rung`` (``nn/blocks.py:dense``)
  models/emformer.py:155, :166     ``einsum_at_rung`` (``Emformer._attend``)
  models/conan/prosody.py:89, :210 ``einsum_at_rung`` (VQ distances, the
                                   forced alignment)
  models/conan/prosody.py:106      ``dot_at_rung`` (the VQ EMA statistic)
  ops/stft.py:110, :126            ``dot_at_rung`` (the STFT loss's DFT and
                                   its transpose, autograd's)
  ops/grouped_conv.py:97, :110     none: the block-diagonal dense form of a
                                   grouped conv is the TPU's layout; the
                                   port's grouped conv is K2-bf16 (above)
  models/emformer.py:233, :248,    none: the banded (segment-windowed)
  :371, :386                       attention; the port's Emformer trains
                                   with dense masked attention, whose two
                                   einsums are :155, :166's
  models/emformer.py:504, :511;    serving only (the streaming step, the
  audio/denoise.py:80;             denoiser, the packed vocoder tail): the
  nn/module.py:58, :60             engine serves at ``exact``/``high``/
                                   ``fast``, never at a training rung

``dot_at_rung`` and ``einsum_at_rung`` run, on a CUDA tensor, one product
with an fp32 result (``_Bf16Product``): cuBLAS's bf16 GEMM through
``torch.mm`` / ``torch.bmm(..., out_dtype=torch.float32)`` (``aten::mm.dtype``,
``bmm.dtype``), which multiply bf16 operands exactly and accumulate and
return fp32. Chosen over TF32 products of the rounded fp32 operands (also
exact: every bf16 value is a TF32 value) because the card's PyTorch (2.11,
CUDA 12.8) registers both overloads, the operands move at half the bytes,
and no global flag has to be set inside the backward, which
``loss.backward()`` runs outside any scope. One route: no probing.
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
    then take their "default" routes (the module's docstring). Read at call
    time."""
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


def rounded_dot(fn, *operands: torch.Tensor) -> torch.Tensor:
    """``fn(*operands)`` in the operands' type on bf16-rounded operands, its
    backward with the incoming gradient rounded too: JAX's DEFAULT exactly,
    on any device. The CPU route of every dot, the card's route of a conv
    K3 does not take (fp32 cuDNN with TF32 off), and the plain version the
    card's products are held to."""
    return _RoundGrad.apply(fn(*(_Round.apply(t) for t in operands)))


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 a [M, K] / [N, M, K] and b [K, N] / [N, K, M'] on the
    card: exact products summed in fp32, an fp32 result."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    return mm(a, b, out_dtype=torch.float32)


class _Bf16Product(torch.autograd.Function):
    """a @ b (2-D, or 3-D batched) of CUDA fp32 tensors at the "default"
    rung: the operands rounded to bf16 once, each product (forward, da =
    g bᵀ, db = aᵀ g, the incoming gradient rounded) through ``_product``;
    the rounded copies are what the backward keeps."""

    @staticmethod
    def forward(ctx, a, b):
        for t in (a, b):
            if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() not in (2, 3):
                raise ValueError(f"bf16 product: no route for a {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}")
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(ab if ctx.needs_input_grad[1] else None,
                              bb if ctx.needs_input_grad[0] else None)
        return _product(ab, bb)

    @staticmethod
    def backward(ctx, g):
        ab, bb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        da = _product(gb, bb.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        db = _product(ab.transpose(-1, -2), gb) if ctx.needs_input_grad[1] else None
        return da, db


def dot_at_rung(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` at the training rung. Under "default": on the
    CPU ``rounded_dot``; on the card one ``_Bf16Product`` (a [..., K] with b
    [K, N] as one [M, K] product, or 3-D a and b as one batched product)."""
    if not _bf16_dots:
        return torch.matmul(a, b)
    if a.device.type == "cpu":
        return rounded_dot(torch.matmul, a, b)
    if b.dim() == 2 and a.dim() != 2:
        y = _Bf16Product.apply(a.reshape(-1, a.shape[-1]), b)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    return _Bf16Product.apply(a, b)


def _bmm_operands(spec: str, a: torch.Tensor, b: torch.Tensor):
    """``torch.einsum(spec, a, b)`` for the port's four patterns as one
    product over explicit permutes: (a', b', finish) with the einsum equal
    to ``finish(a' @ b')``."""
    if spec == "bqhd,bkhd->bhqk":
        B, Q, H, D = a.shape
        return (a.transpose(1, 2).reshape(B * H, Q, D),
                b.permute(0, 2, 3, 1).reshape(B * H, D, b.shape[1]),
                lambda y: y.reshape(B, H, Q, -1))
    if spec == "bhqk,bkhd->bqhd":
        B, H, Q, K = a.shape
        return (a.reshape(B * H, Q, K), b.transpose(1, 2).reshape(B * H, K, -1),
                lambda y: y.reshape(B, H, Q, -1).transpose(1, 2))
    if spec == "btd,nd->btn":
        return a, b.t(), lambda y: y
    if spec == "bqk,bkh->bqh":
        return a, b, lambda y: y
    raise ValueError(f"einsum_at_rung: no product for {spec!r}")


def einsum_at_rung(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, a, b)`` at the training rung: under "default"
    ``dot_at_rung`` of ``_bmm_operands``' product, on either device."""
    if not _bf16_dots:
        return torch.einsum(spec, a, b)
    pa, pb, finish = _bmm_operands(spec, a, b)
    return finish(dot_at_rung(pa, pb))
