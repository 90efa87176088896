"""Rectified flow (``conan_tpu/models/conan/flow.py``): the F0 head and the
mel postnet's flow.

  DiffNet                  WaveNet-style denoiser with strictly causal 2-tap
                           dilated convs; channels-last [B, T, C]
  RectifiedFlow            straight-line interpolation, the velocity loss
                           (``p_losses``), fixed-grid Euler sampling over
                           ``k_step`` of ``timesteps`` with optional
                           classifier-free guidance
  StreamingRectifiedFlow   the same Euler integration chunk by chunk, with
                           each Euler step's denoiser conv carries K-stacked

The Euler loop is a Python loop over K: on the card the engine captures the
whole chunk step, loop included, into one CUDA graph. The clipping constants
are the JAX package's float32 arithmetic done once on the host; the step
indices are made on the device by the same arithmetic. The loss's draws (a
step t per item and the noise x0) come from a ``torch.Generator``, or are
handed in, so that tests can give both packages the same ones.
``DiffNet.params_from_torch`` reads the reference's F0DiffNet / DiffNet
state dict (``params_to_torch`` writes one).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from conan_tpu_torch.checkpoint import params_from_state_dict, state_dict_from_params
from conan_tpu_torch.nn.blocks import init_conv, init_linear, linear, timestep_embedding
from conan_tpu_torch.nn.module import Params, Stream
from conan_tpu_torch.ops.conv import (causal_conv1d, causal_conv1d_state,
                                      causal_conv1d_step, conv1d)
from conan_tpu_torch.parallel import dist


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


@dataclasses.dataclass(frozen=True)
class DiffNetConfig:
    in_dims: int = 1           # 1 for F0, 80 for the mel postnet
    encoder_hidden: int = 256
    residual_layers: int = 10
    residual_channels: int = 192
    dilation_cycle_length: int = 4

    @classmethod
    def mel_from_hparams(cls, hp) -> "DiffNetConfig":
        return cls(in_dims=hp.get("audio_num_mel_bins", 80),
                   encoder_hidden=hp["hidden_size"],
                   residual_layers=hp["residual_layers"],
                   residual_channels=hp["residual_channels"],
                   dilation_cycle_length=hp["dilation_cycle_length"])


class DiffNet:
    """WaveNet-style denoiser with strictly causal dilated convs (the
    reference's masked k=3 conv keeps taps {-d, 0}: a 2-tap causal conv).

    ``apply`` is ``denoise`` after the two conditionings, which depend on the
    step t alone (``step_bias``) and on the condition alone
    (``cond_projection``): the samplers compute each once for all K Euler
    steps instead of once per step."""

    def __init__(self, cfg: DiffNetConfig):
        self.cfg = cfg

    def dilation(self, i: int) -> int:
        return 2 ** (i % self.cfg.dilation_cycle_length)

    def init(self, gen: torch.Generator) -> Params:
        cfg = self.cfg
        C = cfg.residual_channels
        layers = [{"dilated": init_conv(gen, 2 * C, C, 2, init="torch"),
                   "diff_proj": init_linear(gen, C, C),
                   "cond_proj": init_conv(gen, 2 * C, cfg.encoder_hidden, 1,
                                          init="kaiming_relu"),
                   "out_proj": init_conv(gen, 2 * C, C, 1, init="kaiming_relu")}
                  for _ in range(cfg.residual_layers)]
        return {"in_proj": init_conv(gen, C, cfg.in_dims, 1, init="kaiming_relu"),
                "mlp1": init_linear(gen, 4 * C, C),
                "mlp2": init_linear(gen, C, 4 * C),
                "layers": layers,
                "skip_proj": init_conv(gen, C, C, 1, init="kaiming_relu"),
                "out_proj": {"w": torch.zeros(cfg.in_dims, C, 1),
                             "b": torch.zeros(cfg.in_dims)}}

    @staticmethod
    def torch_names(n_layers: int, prefix: str = "") -> Params:
        """The reference state-dict key of each leaf (``checkpoint.py``)."""
        def conv(name):
            return {"w": f"{prefix}{name}.weight", "b": f"{prefix}{name}.bias"}

        layers = [{"dilated": conv(f"residual_layers.{i}.dilated_conv"),
                   "diff_proj": conv(f"residual_layers.{i}.diffusion_projection"),
                   "cond_proj": conv(f"residual_layers.{i}.conditioner_projection"),
                   "out_proj": conv(f"residual_layers.{i}.output_projection")}
                  for i in range(n_layers)]
        return {"in_proj": conv("input_projection"), "mlp1": conv("mlp.0"),
                "mlp2": conv("mlp.2"), "layers": layers, "skip_proj": conv("skip_projection"),
                "out_proj": conv("output_projection")}

    def params_from_torch(self, sd, prefix: str = "", device=None) -> Params:
        """The reference's state dict (keys under ``prefix``) → params on
        ``device`` (None: the card). Its MaskedCausalConv1d of k=3 keeps taps
        0 and 1, this net's 2-tap kernel; the layer count is the state
        dict's."""
        n = 0
        while f"{prefix}residual_layers.{n}.dilated_conv.weight" in sd:
            n += 1
        p = params_from_state_dict(sd, self.torch_names(n, prefix), device)
        for lp in p["layers"]:
            lp["dilated"]["w"] = lp["dilated"]["w"][:, :, :2].contiguous()
        return p

    def params_to_torch(self, params: Params, prefix: str = "") -> dict[str, torch.Tensor]:
        """The inverse: the masked third tap is written as zeros."""
        n = len(params["layers"])
        sd = state_dict_from_params(params, self.torch_names(n, prefix))
        for i in range(n):
            key = f"{prefix}residual_layers.{i}.dilated_conv.weight"
            sd[key] = F.pad(sd[key], (0, 1))
        return sd

    def step_bias(self, params: Params, t: torch.Tensor) -> list[torch.Tensor]:
        """t [N] steps → per layer the [N, C] bias added before its conv."""
        temb = timestep_embedding(t, self.cfg.residual_channels).to(params["mlp1"]["w"].dtype)
        temb = linear(mish(linear(temb, params["mlp1"])), params["mlp2"])
        return [linear(temb, lp["diff_proj"]) for lp in params["layers"]]

    def cond_projection(self, params: Params, cond: torch.Tensor) -> list[torch.Tensor]:
        """cond [B, T, H] → per layer its [B, T, 2C] projection."""
        return [conv1d(cond, lp["cond_proj"]["w"], lp["cond_proj"]["b"])
                for lp in params["layers"]]

    def denoise(self, params: Params, x: torch.Tensor, step_bias: list[torch.Tensor],
                cond_proj: list[torch.Tensor], *, stream: Stream | None = None,
                prefix: str = "dn") -> torch.Tensor:
        """x [B, T, in_dims] → velocity [B, T, in_dims]; ``step_bias`` per
        layer [B or 1, C], ``cond_proj`` per layer [B, T, 2C]."""
        C = self.cfg.residual_channels
        s = stream or Stream(None)
        h = F.relu(conv1d(x, params["in_proj"]["w"], params["in_proj"]["b"]))
        skip_sum = None
        for i, lp in enumerate(params["layers"]):
            y = h + step_bias[i][:, None, :]
            w, b, d = lp["dilated"]["w"], lp["dilated"]["b"], self.dilation(i)
            if s.streaming:
                y, s.new_state[f"{prefix}.{i}"] = causal_conv1d_step(
                    y, s.state[f"{prefix}.{i}"], w, b, dilation=d)
            else:
                y = causal_conv1d(y, w, b, dilation=d)
            y = y + cond_proj[i]
            y = torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])
            y = conv1d(y, lp["out_proj"]["w"], lp["out_proj"]["b"])
            h = (h + y[..., :C]) / math.sqrt(2.0)
            skip_sum = y[..., C:] if skip_sum is None else skip_sum + y[..., C:]
        y = skip_sum / math.sqrt(self.cfg.residual_layers)
        y = F.relu(conv1d(y, params["skip_proj"]["w"], params["skip_proj"]["b"]))
        return conv1d(y, params["out_proj"]["w"], params["out_proj"]["b"])

    def apply(self, params: Params, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
              *, stream: Stream | None = None, prefix: str = "dn") -> torch.Tensor:
        """x [B, T, in_dims] noisy sample, t [B] int steps, cond [B, T, H]
        → velocity [B, T, in_dims]."""
        return self.denoise(params, x, self.step_bias(params, t),
                            self.cond_projection(params, cond), stream=stream, prefix=prefix)

    def init_state(self, batch: int, prefix: str = "dn",
                   device: torch.device | str = "cpu") -> dict:
        C = self.cfg.residual_channels
        return {f"{prefix}.{i}": causal_conv1d_state(batch, C, 2, self.dilation(i),
                                                     device=device)
                for i in range(self.cfg.residual_layers)}


# ---------------------------------------------------------------------------
# Rectified flow (straight-line interpolation + Euler integration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReflowConfig:
    timesteps: int = 1000
    k_step: int = 100
    loss_type: str = "l1"
    sample_clip: bool = True          # hparams['f0_sample_clip']
    qsample_sigma: float = 0.0        # hparams['flow_qsample']=='sig' → 1e-4


def _euler_constants(cfg: ReflowConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The K Euler steps' constants in the JAX package's float32 arithmetic:
    t_idx = int32(f32(i) / K · timesteps), tq = f32(t_idx) / timesteps, and
    the clip's 1 - tq and max(1 - tq, 1e-8)."""
    f32 = np.float32
    t_idx = (np.arange(cfg.k_step, dtype=f32) / f32(cfg.k_step)
             * f32(cfg.timesteps)).astype(np.int32)
    one_minus_tq = f32(1.0) - t_idx.astype(f32) / f32(cfg.timesteps)
    return t_idx, one_minus_tq, np.maximum(one_minus_tq, f32(1e-8))


class RectifiedFlow:
    """Shared math of the F0 flow and the mel postnet's flow."""

    def __init__(self, net: DiffNet, cfg: ReflowConfig):
        self.net = net
        self.cfg = cfg
        _, one_minus_tq, denom = _euler_constants(cfg)
        self._one_minus_tq = [float(v) for v in one_minus_tq]
        self._denom = [float(v) for v in denom]

    def steps(self, device: torch.device) -> torch.Tensor:
        """The K Euler steps' t_idx, made on ``device`` by the same float32
        arithmetic as ``_euler_constants`` (no copy from the host, which a
        CUDA graph capture refuses)."""
        K = self.cfg.k_step
        t = torch.arange(K, device=device, dtype=torch.float32) / K
        return (t * float(self.cfg.timesteps)).to(torch.int32)

    def q_sample(self, x1: torch.Tensor, x0: torch.Tensor, t: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        tf = (t.float() / self.cfg.timesteps)[:, None, None]
        xt = tf * x1 + (1.0 - tf) * x0
        if self.cfg.qsample_sigma > 0 and generator is not None:
            noise = dist.randn(xt.shape, generator, generator.device).to(xt.device)
            xt = xt + self.cfg.qsample_sigma * noise
        return xt

    def draws(self, x1: torch.Tensor, generator: torch.Generator | None):
        """The loss's random parts for target ``x1`` [B, T, C]: (t [B] int
        steps uniform in [0, timesteps), x0 [B, T, C] standard normal), drawn
        from ``generator`` on its device (None: a CPU generator seeded 0),
        then moved to x1's device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dev = generator.device
        t = dist.randint(0, self.cfg.timesteps, (x1.shape[0],), generator, dev)
        x0 = dist.randn(x1.shape, generator, dev)
        return t.to(x1.device), x0.to(x1.device)

    def p_losses(self, params: Params, x1: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                 x0: torch.Tensor, *, generator: torch.Generator | None = None,
                 nonpadding: torch.Tensor | None = None) -> torch.Tensor:
        """The velocity loss: x1 [B, T, C] target, t [B] int steps, cond
        [B, T, H], x0 [B, T, C] noise (``draws``) → the mean L1 (or L2,
        ``loss_type``) between x1 - x0 and the denoiser's velocity at
        x_t = t/T·x1 + (1 - t/T)·x0, over ``nonpadding`` ([B, T] or
        [B, T, 1]) where given. ``generator`` draws q_sample's noise when
        ``qsample_sigma`` > 0."""
        xt = self.q_sample(x1, x0, t, generator)
        v_pred = self.net.apply(params, xt, t, cond)
        ut = x1 - x0
        err = torch.abs(ut - v_pred) if self.cfg.loss_type == "l1" else torch.square(ut - v_pred)
        if nonpadding is None:
            return dist.batch_mean(err)
        m = nonpadding[..., None] if nonpadding.dim() == 2 else nonpadding
        return torch.sum(err * m) / (dist.global_count(torch.sum(m.expand_as(err))) + 1e-8)

    def euler_update(self, k: int, x: torch.Tensor, ut: torch.Tensor,
                     dyn_clip: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
        """x after Euler step k from velocity ``ut``; with ``sample_clip`` the
        implied x1 is clipped first, at the quantized t (the reference
        Wrapper's): to [lo, hi] of ``dyn_clip`` (tensors broadcast against
        x, read on the device, so a captured graph reads their values at
        each replay), else to [-1, 1]."""
        if self.cfg.sample_clip:
            x_recon = ut * self._one_minus_tq[k] + x
            if dyn_clip is None:
                x_recon = torch.clamp(x_recon, -1.0, 1.0)
            else:
                lo, hi = dyn_clip
                if not (torch.is_tensor(lo) and torch.is_tensor(hi)):
                    raise TypeError("dyn_clip: pass the bounds as tensors")
                x_recon = torch.minimum(torch.maximum(x_recon, lo), hi)
            ut = (x_recon - x) / self._denom[k]
        return x + ut / self.cfg.k_step

    def sample(self, params: Params, cond: torch.Tensor, x0: torch.Tensor,
               dyn_clip: tuple[torch.Tensor, torch.Tensor] | None = None,
               ucond: torch.Tensor | None = None, cfg_scale: float = 1.0) -> torch.Tensor:
        """Fixed-step Euler from t=0 to 1 over k_step steps. cond [B, T, H],
        x0 [B, T, C] initial noise → x1 [B, T, C]. ``dyn_clip`` (lo, hi)
        clips the implied x1 in place of [-1, 1] (``euler_update``). With
        ``ucond`` (the unconditional condition, [B, T, H]) each step's
        velocity is the classifier-free guided v_u + cfg_scale · (v_c - v_u)."""
        net = self.net
        bias = net.step_bias(params, self.steps(x0.device))
        cproj = net.cond_projection(params, cond)
        uproj = None if ucond is None else net.cond_projection(params, ucond)
        x = x0
        for k in range(self.cfg.k_step):
            bk = [b[k:k + 1] for b in bias]
            ut = net.denoise(params, x, bk, cproj)
            if uproj is not None:
                v_u = net.denoise(params, x, bk, uproj)
                ut = v_u + cfg_scale * (ut - v_u)
            x = self.euler_update(k, x, ut, dyn_clip)
        return x


class StreamingRectifiedFlow:
    """Chunkwise rectified-flow sampling. The denoiser is strictly causal, so
    frame i's Euler trajectory depends only on frames ≤ i: carrying, for each
    of the K Euler steps, the denoiser's conv input tails from the previous
    chunk reproduces the offline trajectory (given the same per-frame initial
    noise). State: per layer one [K, B, d, C] tensor of the K steps' carries."""

    def __init__(self, flow: RectifiedFlow):
        self.flow = flow

    def init_state(self, batch: int, device: torch.device | str = "cpu") -> dict:
        K = self.flow.cfg.k_step
        return {k: torch.zeros((K,) + tuple(v.shape), device=device)
                for k, v in self.flow.net.init_state(batch, prefix="dn").items()}

    def step(self, params: Params, conv_states: dict, cond_chunk: torch.Tensor,
             x0_chunk: torch.Tensor,
             dyn_clip: tuple[torch.Tensor, torch.Tensor] | None = None):
        """cond [B, Tc, H], x0 [B, Tc, C] → (x1 [B, Tc, C], states');
        ``dyn_clip`` as in ``RectifiedFlow.sample``, the chunk's bounds."""
        flow, net = self.flow, self.flow.net
        bias = net.step_bias(params, flow.steps(x0_chunk.device))
        cproj = net.cond_projection(params, cond_chunk)
        carries: dict = {key: [] for key in conv_states}
        x = x0_chunk
        for k in range(flow.cfg.k_step):
            s = Stream({key: v[k] for key, v in conv_states.items()})
            ut = net.denoise(params, x, [b[k:k + 1] for b in bias], cproj, stream=s,
                             prefix="dn")
            x = flow.euler_update(k, x, ut, dyn_clip)
            for key, carry in s.new_state.items():
                carries[key].append(carry)
        return x, {key: torch.stack(v) for key, v in carries.items()}


def minmax_norm_f0(x: torch.Tensor, uv: torch.Tensor | None = None) -> torch.Tensor:
    """log2-F0 → [-1, 1]."""
    y = (x - 6.0) / 4.0 * 2.0 - 1.0
    if uv is not None:
        y = torch.where(uv > 0, torch.zeros_like(y), y)
    return y


def minmax_denorm_f0(x: torch.Tensor, uv: torch.Tensor | None = None) -> torch.Tensor:
    y = (x + 1.0) / 2.0 * 4.0 + 6.0
    if uv is not None:
        y = torch.where(uv > 0, torch.zeros_like(y), y)
    return y


def norm_spec(x: torch.Tensor, spec_min: torch.Tensor, spec_max: torch.Tensor) -> torch.Tensor:
    """Mel → [-1, 1] per bin between the dataset's spec_min and spec_max."""
    return (x - spec_min) / (spec_max - spec_min) * 2.0 - 1.0


def denorm_spec(x: torch.Tensor, spec_min: torch.Tensor, spec_max: torch.Tensor) -> torch.Tensor:
    return (x + 1.0) / 2.0 * (spec_max - spec_min) + spec_min
