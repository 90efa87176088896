"""The "default" training rung's folds and routes (``conan_tpu_torch/ops/conv.py``,
``ops/precision.py``) on the CPU.

- Each fold is exact: ``conv2d`` (the MPD's (k, 1) layers at every period,
  the window discriminators' 3x3 stride-2 layers) and ``conv_transpose1d``
  (the ``nn`` upsampler's, the non-causal generator's) under "default" in
  float64 against ``F.conv2d`` / ``F.conv_transpose1d`` of the bf16-rounded
  operands, value and gradients (the incoming gradient rounded) within
  1e-12: the fold rearranges the same products, and float64 sums them.
- Each route matches JAX: the port's fp32 route against the JAX package's
  ``conv2d``, ``conv_transpose1d``, ``jnp.matmul`` and ``jnp.einsum`` under
  its ``precision_scope("default")`` on rounded inputs, value and VJP (the
  cotangent rounded); on the CPU JAX computes DEFAULT in fp32, so both sum
  the same exact products in fp32 (relative L2 within 1e-5).
- One small "default" step of each task: every conv2d, conv_transpose1d
  and dot call ends in K3's wrapper, ``rounded_dot`` or the fp32-output
  product, no aten product returns bf16, and ``bf16_dot`` is gone.

Inputs are made from a seed with numpy.
"""

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conan_tpu.ops import conv as jax_conv
from conan_tpu.ops.precision import precision_scope

from conan_tpu_torch.ops import conv as conv_ops
from conan_tpu_torch.ops import denseconv as dc
from conan_tpu_torch.ops import precision
from conan_tpu_torch.ops.precision import dot_at_rung, einsum_at_rung, training_scope

from tests.torch_port_util import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
FOLD_TOL = 1e-12
REL = 1e-5


def _rnd(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _arrays(seed: int, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _at_default_and_grads(fn, inputs, g):
    """fn(*inputs) under "default" and the gradients of every input for the
    incoming gradient g."""
    ins = [t.clone().requires_grad_(True) for t in inputs]
    with training_scope("default", CPU):
        y = fn(*ins)
        return (y.detach(), *torch.autograd.grad(y, ins, g))


def _reference_and_grads(fn, inputs, g):
    """fn on the rounded operands (the first two inputs; a third, the bias,
    as it is) and its gradients: the operands' for the rounded g, the
    bias's for g (its add is no product)."""
    ins = [(_rnd(t) if i < 2 else t).clone().requires_grad_(True) for i, t in enumerate(inputs)]
    y = fn(*ins)
    grads = torch.autograd.grad(y, ins[:2], _rnd(g), retain_graph=len(ins) > 2)
    return (y.detach(), *grads, *(torch.autograd.grad(y, ins[2:], g) if len(ins) > 2 else ()))


def _assert_close(got, want, tol, what):
    for name, a, b in zip(("y", "dx", "dw", "db"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= tol, (what, name, err)


# (H, k, stride, pad): the MPD's layers 1-4, layer 5 and post
MPD_LAYERS = [(5, 3, 2), (5, 1, 2), (3, 1, 1)]
# (Cin, Cout) a layer at test width: the MPD's first layer takes 1 or 2
MPD_CHANNELS = [(1, 8), (2, 8), (8, 16)]


@pytest.mark.parametrize("period", [2, 3, 5, 7, 11])
def test_mpd_conv2d_fold_is_exact(period):
    """The MPD's (k, 1) conv2d over [T/p, p] at each period: every layer's
    kernel, stride and padding, first-layer inputs of 1 and 2 channels."""
    H = 31
    for k, s, pad in MPD_LAYERS:
        for ci, co in MPD_CHANNELS:
            x, w, b, = (torch.from_numpy(a) for a in _arrays(
                period * 100 + k * 10 + s + ci, (2, ci, H, period), (co, ci, k, 1), (co,)))
            conv = dict(stride=(s, 1), padding=(pad, 0))
            ref = functools.partial(F.conv2d, **conv)
            g = torch.from_numpy(_arrays(ci, tuple(ref(x, w, b).shape))[0])
            got = _at_default_and_grads(lambda xx, ww, bb: conv_ops.conv2d(xx, ww, bb, **conv),
                                        (x, w, b), g)
            _assert_close(got, _reference_and_grads(ref, (x, w, b), g), FOLD_TOL,
                          (period, k, s, ci))


@pytest.mark.parametrize("H,W,ci", [(32, 20, 1), (16, 10, 8), (8, 5, 8), (9, 7, 1)])
def test_window_conv2d_fold_is_exact(H, W, ci):
    """The window discriminators' 3x3 conv2d at stride 2, padding 1, on even
    and odd maps."""
    co = 8
    x, w, b = (torch.from_numpy(a) for a in _arrays(H * W + ci, (2, ci, H, W), (co, ci, 3, 3),
                                                      (co,)))
    ref = functools.partial(F.conv2d, stride=2, padding=1)
    g = torch.from_numpy(_arrays(H, tuple(ref(x, w, b).shape))[0])
    got = _at_default_and_grads(lambda xx, ww, bb: conv_ops.conv2d(xx, ww, bb, stride=2,
                                                                   padding=1), (x, w, b), g)
    _assert_close(got, _reference_and_grads(ref, (x, w, b), g), FOLD_TOL, (H, W, ci))


@pytest.mark.parametrize("H,W,k,stride,pad", [(14, 5, (3, 1), (4, 1), (0, 0)),
                                              (13, 11, (3, 3), (4, 3), (0, 1))])
def test_conv2d_fold_crops_rows_no_window_reads(H, W, k, stride, pad):
    """A stride whose last window ends before the map does: the fold's
    phase grid is shorter than the padded map (a negative pad, a crop), its
    adjoint gives those rows a zero gradient."""
    ci, co = 8, 8
    fold = conv_ops.conv2d_fold((2, ci, H, W), (co, ci, *k), stride, pad)
    assert min(fold._pads()) < 0
    x, w, b = (torch.from_numpy(a) for a in _arrays(H + W, (2, ci, H, W), (co, ci, *k), (co,)))
    ref = functools.partial(F.conv2d, stride=stride, padding=pad)
    g = torch.from_numpy(_arrays(W, tuple(ref(x, w, b).shape))[0])
    got = _at_default_and_grads(lambda xx, ww, bb: conv_ops.conv2d(xx, ww, bb, stride=stride,
                                                                   padding=pad), (x, w, b), g)
    _assert_close(got, _reference_and_grads(ref, (x, w, b), g), FOLD_TOL, (H, W, k, stride))


# (T, Cin, Cout, K, stride, padding, output_padding): the non-causal
# generator's four ups ((k - u) // 2 padding, kernels 16/11/8/4 at 8/5/4/2),
# the "nn" upsampler's (no padding, output_padding u - 1) at the shipped
# kernels 16/10/8/4, and a fold whose output needs more rows than its input
# has (output_padding past the taps)
TRANSPOSED = [(6, 16, 8, 16, 8, 4, 0), (7, 8, 8, 11, 5, 3, 0), (9, 8, 8, 8, 4, 2, 0),
              (10, 8, 16, 4, 2, 1, 0), (6, 16, 8, 16, 8, 0, 7), (6, 8, 8, 10, 5, 0, 4),
              (5, 8, 8, 8, 4, 0, 3), (5, 8, 4, 4, 2, 0, 1), (4, 8, 8, 3, 4, 0, 3)]


@pytest.mark.parametrize("case", TRANSPOSED)
def test_conv_transpose1d_fold_is_exact(case):
    T, ci, co, K, u, pad, op = case
    x, w, b = (torch.from_numpy(a) for a in _arrays(sum(case), (2, T, ci), (ci, co, K), (co,)))
    conv = dict(stride=u, padding=pad, output_padding=op)

    def ref(xx, ww, bb):
        return F.conv_transpose1d(xx.transpose(1, 2), ww, bb, **conv).transpose(1, 2)

    g = torch.from_numpy(_arrays(K, tuple(ref(x, w, b).shape))[0])
    got = _at_default_and_grads(lambda xx, ww, bb: conv_ops.conv_transpose1d(xx, ww, bb, **conv),
                                (x, w, b), g)
    _assert_close(got, _reference_and_grads(ref, (x, w, b), g), FOLD_TOL, case)


# ---------------------------------------------------------------------------
# the fp32 routes against the JAX package at DEFAULT on rounded inputs
# ---------------------------------------------------------------------------

def _against_jax(port_fn, jax_fn, arrays, seed):
    """port_fn at "default" (fp32, on the CPU) against jax_fn under JAX's
    DEFAULT on the rounded arrays (the first two: the operands; a third, the
    bias, as it is), value and VJP with a rounded cotangent."""
    t = [torch.from_numpy(a) for a in arrays]
    with precision_scope("default"):
        ins = [jnp.asarray(_rnd(a).numpy() if i < 2 else a.numpy()) for i, a in enumerate(t)]
        y_j, vjp = jax.vjp(jax_fn, *ins)
        g = _rnd(torch.from_numpy(_arrays(seed, y_j.shape, dtype=np.float32)[0]))
        want = (y_j, *vjp(jnp.asarray(g.numpy())))
    got = _at_default_and_grads(port_fn, t, g)
    for name, a, b in zip(("y", "d0", "d1", "d2"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        assert _rel(a.detach(), b) <= REL, (name, _rel(a.detach(), b))


@pytest.mark.parametrize("what", ["mpd", "window"])
def test_conv2d_route_matches_jax(what):
    """conv2d at "default" against ``conan_tpu.ops.conv.conv2d`` (channels-
    last there): the MPD's stride-3 (5, 1) layer at period 3 (K3's plain
    version: 96 channels after the fold) and the window's first layer (8)."""
    if what == "mpd":
        shapes, conv = ((2, 32, 40, 3), (64, 32, 5, 1), (64,)), dict(stride=(3, 1), padding=(2, 0))
    else:
        shapes, conv = ((2, 1, 32, 20), (16, 1, 3, 3), (16,)), dict(stride=(2, 2), padding=(1, 1))
    arrays = _arrays(7, *shapes, dtype=np.float32)
    fold = conv_ops.conv2d_fold(shapes[0], shapes[1], conv["stride"], conv["padding"])
    assert dc.dense_kernel_takes(*fold.geometry)

    def jax_fn(x, w, b):
        y = jax_conv.conv2d(x.transpose(0, 2, 3, 1), w, b, stride=conv["stride"],
                            padding=[(p, p) for p in conv["padding"]])
        return y.transpose(0, 3, 1, 2)

    _against_jax(lambda x, w, b: conv_ops.conv2d(x, w, b, **conv), jax_fn, arrays, seed=8)


@pytest.mark.parametrize("case", [(6, 16, 8, 16, 8, 4, 0), (6, 16, 8, 16, 8, 0, 7)])
def test_conv_transpose1d_route_matches_jax(case):
    T, ci, co, K, u, pad, op = case
    arrays = _arrays(9, (2, T, ci), (ci, co, K), (co,), dtype=np.float32)
    conv = dict(stride=u, padding=pad, output_padding=op)
    _against_jax(lambda x, w, b: conv_ops.conv_transpose1d(x, w, b, **conv),
                 lambda x, w, b: jax_conv.conv_transpose1d(x, w, b, **conv), arrays, seed=10)


EINSUMS = [("bqhd,bkhd->bhqk", (2, 5, 3, 8), (2, 7, 3, 8)),
           ("bhqk,bkhd->bqhd", (2, 3, 5, 7), (2, 7, 3, 8)),
           ("btd,nd->btn", (2, 5, 8), (6, 8)), ("bqk,bkh->bqh", (2, 5, 7), (2, 7, 8))]


@pytest.mark.parametrize("spec,a,b", EINSUMS)
def test_einsum_route_matches_jax(spec, a, b):
    _against_jax(lambda x, y: einsum_at_rung(spec, x, y),
                 lambda x, y: jnp.einsum(spec, x, y, precision=jax.lax.Precision.DEFAULT),
                 _arrays(11, a, b, dtype=np.float32), seed=12)


@pytest.mark.parametrize("a,b", [((3, 7, 24), (24, 16)), ((40, 12), (12, 6)),
                                 ((6, 30), (30, 8))])
def test_matmul_route_matches_jax(a, b):
    """dense's x @ wᵀ, the STFT loss's frames @ basis, the VQ EMA's
    onehotᵀ @ x shapes."""
    _against_jax(dot_at_rung, lambda x, y: jnp.matmul(x, y, precision=jax.lax.Precision.DEFAULT),
                 _arrays(13, a, b, dtype=np.float32), seed=14)


def test_card_route_einsum_permutes_match_einsum():
    """``einsum_at_rung``'s permutes (``_bmm_operands``, the route on both
    devices) give each einsum's value and gradients in float64."""
    for spec, a, b in EINSUMS:
        x, y = (torch.from_numpy(v) for v in _arrays(15, a, b))
        g = torch.from_numpy(_arrays(16, tuple(torch.einsum(spec, x, y).shape))[0])
        got = _at_default_and_grads(functools.partial(einsum_at_rung, spec), (x, y), g)
        want = _reference_and_grads(functools.partial(torch.einsum, spec), (x, y), g)
        _assert_close(got, want, FOLD_TOL, spec)


# ---------------------------------------------------------------------------
# the route of every conv2d, conv_transpose1d and dot call in a small step
# ---------------------------------------------------------------------------

ENTRIES = ("conv2d", "conv_transpose1d", "dot_at_rung", "einsum_at_rung")


@contextlib.contextmanager
def _routes(monkeypatch):
    """Records, for every call of an entry (ENTRIES, in every port module that
    imported it by name), the products its call ended in: K3's wrapper
    (with the geometry K3 takes), ``rounded_dot`` or ``_Bf16Product``."""
    calls, stack = [], []

    def entry(name, fn):
        def spy(*a, **k):
            if stack:             # an entry inside another's call is part of that call
                return fn(*a, **k)
            stack.append([name])
            try:
                return fn(*a, **k)
            finally:
                calls.append(tuple(stack.pop()))
        return spy

    def leaf(name, fn):
        def spy(*a, **k):
            if stack:
                stack[-1].append(name)
            return fn(*a, **k)
        return spy

    def k3(x, w, b=None, **kw):
        f = kw.get("fold")
        assert dc.dense_kernel_takes(*(f.geometry if f else (x.shape[-1], w.shape[0],
                                                              w.shape[-1], kw["dilation"])))
        return real_k3(x, w, b, **kw)

    real_k3 = conv_ops.denseconv
    monkeypatch.setattr(conv_ops, "denseconv", leaf("k3", k3))
    for mod in (conv_ops, precision):
        monkeypatch.setattr(mod, "rounded_dot", leaf("rounded_dot", mod.rounded_dot))
    monkeypatch.setattr(precision._Bf16Product, "apply",
                        leaf("bf16_product", precision._Bf16Product.apply))
    for name in ENTRIES:
        orig = getattr(conv_ops if name.startswith("conv") else precision, name)
        for mod_name, mod in list(sys.modules.items()):
            if mod_name.startswith("conan_tpu_torch") and getattr(mod, name, None) is orig:
                monkeypatch.setattr(mod, name, entry(name, orig))
    yield calls


def _vocoder_step():
    """The vocoder step's products at test width under "default", forward
    and backward (a whole VocoderTask step on the CPU takes ~16 s, most of
    it the fixed 1024-channel discriminators): the non-causal generator
    (four transposed convs), a conditional period discriminator (its mel
    upsampler's matmul, every (k, 1) conv2d layer) at narrow widths, the
    spectrogram discriminator's window conv2d, the STFT loss's DFT."""
    from conan_tpu_torch.checkpoint import tree_leaves, tree_map
    from conan_tpu_torch.models.vocoder import discriminators as discs
    from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig
    from conan_tpu_torch.models.vocoder.hifigan_noncausal import NonCausalHifiGanGenerator
    from conan_tpu_torch.ops.stft import stft_realimag

    from tests.test_train_steps import VOC_HP

    gen = torch.Generator().manual_seed(0)
    g = NonCausalHifiGanGenerator(HifiGanConfig.from_hparams(
        dict(VOC_HP, upsample_kernel_sizes=[16, 11, 8, 4])))
    mpd = discs.DiscriminatorP(3, use_cond=True)
    mpd.layers = [(2, 8), (8, 16), (16, 32), (32, 32), (32, 32)]
    specd = discs.MultiWindowDiscriminator(time_lengths=(8,), hidden=8)
    params = [g.init(gen), dict(mpd.init(gen), post=discs._wn_conv_init(gen, 1, 32, 3, 1)),
              specd.init(gen)]
    params = tree_map(lambda t: t.requires_grad_(True), params)
    mel = torch.from_numpy((np.random.default_rng(3).standard_normal((1, 8, 80)) - 4
                            ).astype(np.float32)).requires_grad_(True)
    with training_scope("default", CPU):
        wav = g.apply(params[0], mel)
        logits, _ = mpd.forward(params[1], wav, mel)
        validity = specd.apply(params[2], mel)[0]
        re, im = stft_realimag(wav[..., 0], n_fft=512, hop=160, at_rung=True)
        loss = logits.sum() + validity.sum() + (re * re + im * im).mean()
        return torch.autograd.grad(loss, tree_leaves(params) + [mel])


def _emformer_step():
    from conan_tpu_torch.train.tasks import EmformerTask

    hp = {"emformer_input_dim": 16, "emformer_layers": 2, "chunk_size": 80, "right_context": 2,
          "emformer_output_dim": 10, "lr": 1e-3, "warmup_steps": 2, "warmup_init_lr": 1e-4,
          "train_precision": "default"}
    rng = np.random.default_rng(3)
    task = EmformerTask(hp, device="cpu")
    batch = {"mels": rng.standard_normal((2, 26, 16)).astype(np.float32),
             "content": rng.integers(0, 10, (2, 24))}
    return task.train_step(task.init_state(torch.Generator().manual_seed(0)), batch)


# the entries each small step must reach
WANT = {"vocoder": {"conv2d", "conv_transpose1d", "dot_at_rung"},
        "conan": {"conv2d", "dot_at_rung", "einsum_at_rung"},
        "emformer": {"dot_at_rung", "einsum_at_rung"}, "postnet": {"dot_at_rung", "einsum_at_rung"}}


@pytest.mark.parametrize("task", ["vocoder", "conan", "emformer", "postnet"])
def test_route_of_every_product_in_a_small_default_step(task, monkeypatch):
    """Every conv2d, conv_transpose1d and dot call of one small "default"
    step ends in exactly one product: K3's wrapper where the fold's
    geometry is K3's, else ``rounded_dot`` (on the CPU the dots' route);
    no aten product or conv returns bf16; ``bf16_dot`` is gone."""
    from chip_smoke import bf16_output_ops

    from tests.test_torch_denseconv import _small_step

    assert not hasattr(precision, "bf16_dot")
    step = {"vocoder": _vocoder_step, "emformer": _emformer_step}.get(
        task, functools.partial(_small_step, task))
    with _routes(monkeypatch) as calls, bf16_output_ops() as bf16_ops:
        step()
    assert {c[0] for c in calls} == WANT[task]
    bad = [c for c in calls if len(c) != 2 or c[1] not in ("k3", "rounded_dot")]
    assert not bad, bad[:5]
    if task in ("vocoder", "conan"):     # the MPD's 96-channel fold, the windows' 8·8-channel
        assert any(c == ("conv2d", "k3") for c in calls)
    assert not bf16_ops, bf16_ops
