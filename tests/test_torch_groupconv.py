"""The port's grouped conv (kernel K2's plain version, its CPU route, and its
autograd Function, whose backward runs on the card too) against the JAX
package's ``ops.conv1d(groups=g)`` and its Pallas kernel in interpret mode,
on the MSD's five grouped geometries (tests/test_pallas_groupconv.py:15-21);
and, on the CPU, the CUDA kernel's operands: the tf32 split of its weights,
their layout, and the three-product accuracy emulated with float64 convs.

Tolerances are those tests/test_pallas_groupconv.py holds the Pallas kernel
to: values atol 2e-4 / rtol 1e-4, both gradients atol 5e-4 / rtol 1e-3 (fp32
sums of up to 41 · 64 terms in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_tpu import ops as jops
from conan_tpu.ops.pallas_groupconv import pallas_grouped_conv1d

from conan_tpu_torch.ops import conv1d
from conan_tpu_torch.ops.groupconv import (GroupConvKernel, _GroupConvFunction,
                                           grouped_conv1d_reference, groupconv, kernel_weights,
                                           tf32_split)

from tests.test_pallas_groupconv import MSD_LAYERS
from tests.torch_port_util import one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-4, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3


def _inputs(ci, co, k, g, seed):
    rng = np.random.default_rng(seed)
    T = 120 if ci <= 256 else 50
    x = rng.standard_normal((2, T, ci)).astype(np.float32)
    w = (rng.standard_normal((co, ci // g, k)) * 0.1).astype(np.float32)
    b = rng.standard_normal((co,)).astype(np.float32)
    return x, w, b


def _jax(fn, x, w, b, s, pad, g):
    def loss(xx, ww):
        return jnp.sum(jnp.sin(fn(xx, ww, b, stride=s, padding=(pad, pad), groups=g)))

    y = fn(x, w, b, stride=s, padding=(pad, pad), groups=g)
    return np.asarray(y), [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1))(x, w)]


def _port(fn, x, w, b):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = fn(xt, wt) + torch.from_numpy(b)
    torch.sin(y).sum().backward()
    return y.detach().numpy(), [xt.grad.numpy(), wt.grad.numpy()]


@pytest.mark.parametrize("ci,co,k,s,g", MSD_LAYERS)
def test_groupconv_matches_jax(ci, co, k, s, g):
    x, w, b = _inputs(ci, co, k, g, seed=ci + co)
    pad = (k - 1) // 2
    want, want_grads = _jax(jops.conv1d, x, w, b, s, pad, g)
    routes = {
        "ops.conv1d": lambda xx, ww: conv1d(xx, ww, stride=s, padding=(pad, pad), groups=g),
        "function": lambda xx, ww: _GroupConvFunction.apply(xx, ww, s, (pad, pad), g,
                                                            groupconv),
    }
    for name, fn in routes.items():
        got, got_grads = _port(fn, x, w, b)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)
        for a, c in zip(got_grads, want_grads):
            np.testing.assert_allclose(a, c, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_groupconv_matches_jax_pallas_interpret():
    ci, co, k, s, g = MSD_LAYERS[1]
    x, w, b = _inputs(ci, co, k, g, seed=7)
    want, want_grads = _jax(lambda *a, **kw: pallas_grouped_conv1d(*a, interpret=True, **kw),
                            x, w, b, s, 20, g)
    got, got_grads = _port(lambda xx, ww: grouped_conv1d_reference(
        xx, ww, stride=s, padding=(20, 20), groups=g), x, w, b)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for a, c in zip(got_grads, want_grads):
        np.testing.assert_allclose(a, c, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_backward_computes_only_what_is_asked():
    x, w, _ = _inputs(128, 256, 41, 16, seed=3)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = _GroupConvFunction.apply(xt, torch.from_numpy(w), 2, (20, 20), 16, groupconv)
    y.sum().backward()
    assert xt.grad is not None and xt.grad.shape == xt.shape


def test_cpu_route_launches_nothing_and_other_devices_raise():
    kernel = GroupConvKernel()
    x, w, _ = _inputs(128, 128, 41, 4, seed=4)
    got = kernel(torch.from_numpy(x), torch.from_numpy(w), stride=2, padding=(20, 20), groups=4)
    want = grouped_conv1d_reference(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                                    padding=(20, 20), groups=4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernel.launches == 0
    with pytest.raises(ValueError, match="no kernel"):
        kernel(torch.empty(1, 100, 8, device="meta"), torch.empty(8, 2, 41, device="meta"),
               groups=4)


# K2's operands (csrc/groupconv.cu): the three-product tf32 split, whose
# weight half the wrapper makes on the CPU or the card alike

def _tf32_low_bits(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_split_is_hi_plus_lo():
    """hi and lo are tf32 values (low 13 mantissa bits zero) whose sum is w
    to 2^-22 of |w|; a non-contiguous w gives contiguous halves (the kernel
    reads them as laid out)."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((64, 16, 41)) * 10.0 ** rng.integers(
        -6, 6, (64, 16, 41))).astype(np.float32)).permute(2, 0, 1)
    hi, lo = tf32_split(w)
    assert hi.is_contiguous() and lo.is_contiguous()
    assert int(_tf32_low_bits(hi).abs().max()) == 0 and int(_tf32_low_bits(lo).abs().max()) == 0
    err = (hi.double() + lo.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
    # round to nearest, ties away from zero: 1 + 2^-11 is halfway between tf32 neighbours
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=torch.float32)
    torch.testing.assert_close(tf32_split(tie)[0],
                               torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10)]), rtol=0, atol=0)


def test_kernel_weights_layout():
    """[groups, K·cig/8, cog, 8]: k-step j·cig/8 + ci/8, out-channel, ci % 8."""
    G, cog, cig, K = 4, 16, 24, 5
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((G * cog, cig, K))
                         .astype(np.float32))
    hi, lo = kernel_weights(w, G)
    assert hi.shape == lo.shape == (G, K * cig // 8, cog, 8)
    full = hi.double() + lo.double()
    for g, co, ci, j in [(0, 0, 0, 0), (1, 5, 9, 3), (3, 15, 23, 4), (2, 7, 16, 1)]:
        want = float(w[g * cog + co, ci, j])
        assert abs(float(full[g, j * cig // 8 + ci // 8, co, ci % 8]) - want) \
            <= 2.0 ** -22 * abs(want)


@pytest.mark.parametrize("ci,co,k,s,g", MSD_LAYERS)
def test_three_tf32_products_keep_fp32_accuracy(ci, co, k, s, g):
    """The kernel's product, emulated on the CPU: both operands split by
    tf32_split, x_hi·w_hi + x_lo·w_hi + x_hi·w_lo by three float64 convs.
    Within the plain version's atol 2e-4 / rtol 1e-4, and no further from a
    float64 conv than 8x the fp32 conv's own error."""
    x, w, _ = _inputs(ci, co, k, g, seed=ci + co + 1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    pad = (k - 1) // 2

    def conv(a, b):
        return grouped_conv1d_reference(a, b, stride=s, padding=(pad, pad), groups=g)

    (xh, xl), (wh, wl) = tf32_split(xt), tf32_split(wt)
    three = conv(xh.double(), wh.double()) + conv(xl.double(), wh.double()) \
        + conv(xh.double(), wl.double())
    fp32, exact = conv(xt, wt), conv(xt.double(), wt.double())
    np.testing.assert_allclose(three.float().numpy(), fp32.numpy(), atol=ATOL, rtol=RTOL)
    assert float((three - exact).abs().max()) <= 8 * float((fp32.double() - exact).abs().max())
