"""The mel rectified-flow postnet, stage 4 (``conan_tpu/models/conan/postnet.py``).

It refines the frozen Conan's coarse mel: the condition is
Linear(concat(coarse mel_out, decoder_inp)), and a rectified flow (a 20×256
DiffNet at the shipped config) runs over the spec-normalized mel, trained by
the velocity loss and sampled by fixed-step Euler (K = 25, no clip), with
optional classifier-free guidance.
"""

from __future__ import annotations

import dataclasses

import torch

from conan_tpu_torch.models.conan.flow import (DiffNet, DiffNetConfig, RectifiedFlow,
                                               ReflowConfig, denorm_spec, norm_spec)
from conan_tpu_torch.nn.blocks import init_linear, linear
from conan_tpu_torch.nn.module import Params


@dataclasses.dataclass(frozen=True)
class PostnetConfig:
    hidden_size: int = 256
    n_mels: int = 80
    timesteps: int = 1000
    k_step: int = 25
    loss_type: str = "l1"
    residual_layers: int = 20
    residual_channels: int = 256
    dilation_cycle_length: int = 4
    spec_min: tuple[float, ...] = (-6.0,) * 80
    spec_max: tuple[float, ...] = (0.0,) * 80

    @classmethod
    def from_hparams(cls, hp) -> "PostnetConfig":
        """The config's postnet keys; ``spec_min``/``spec_max`` must be lists
        by now (``train.run.build_task`` fills them from ``spec_stats.npz``
        where the config has null)."""
        net = DiffNetConfig.mel_from_hparams(hp)
        return cls(hidden_size=net.encoder_hidden, n_mels=net.in_dims,
                   timesteps=hp.get("timesteps", 1000), k_step=hp.get("K_step", 25),
                   loss_type=hp.get("flow_loss_type", "l1"),
                   residual_layers=net.residual_layers,
                   residual_channels=net.residual_channels,
                   dilation_cycle_length=net.dilation_cycle_length,
                   spec_min=tuple(hp["spec_min"]), spec_max=tuple(hp["spec_max"]))


class ConanPostnet:
    def __init__(self, cfg: PostnetConfig):
        self.cfg = cfg
        self.net = DiffNet(DiffNetConfig(
            in_dims=cfg.n_mels, encoder_hidden=cfg.hidden_size,
            residual_layers=cfg.residual_layers, residual_channels=cfg.residual_channels,
            dilation_cycle_length=cfg.dilation_cycle_length))
        self.flow = RectifiedFlow(self.net, ReflowConfig(
            timesteps=cfg.timesteps, k_step=cfg.k_step, loss_type=cfg.loss_type,
            sample_clip=False))

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters with the JAX package's tree and distributions."""
        cfg = self.cfg
        return {"ln_proj": init_linear(gen, cfg.hidden_size, cfg.n_mels + cfg.hidden_size),
                "flownet": self.net.init(gen)}

    def _spec_range(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.tensor(self.cfg.spec_min, dtype=torch.float32, device=device),
                torch.tensor(self.cfg.spec_max, dtype=torch.float32, device=device))

    def condition(self, params: Params, coarse_mel: torch.Tensor,
                  decoder_inp: torch.Tensor) -> torch.Tensor:
        """Linear(concat(coarse mel [B, T, 80] detached, decoder_inp [B, T, H]))."""
        return linear(torch.cat([coarse_mel.detach(), decoder_inp], dim=-1), params["ln_proj"])

    def target(self, gt_mel: torch.Tensor) -> torch.Tensor:
        """The flow's target: the mel normalized to [-1, 1] per bin."""
        return norm_spec(gt_mel, *self._spec_range(gt_mel.device))

    def loss(self, params: Params, coarse_mel: torch.Tensor, decoder_inp: torch.Tensor,
             gt_mel: torch.Tensor, t: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """The velocity loss on the spec-normalized gt mel, at steps t [B] from
        noise x0 [B, T, 80] (``flow.draws(self.target(gt_mel), generator)``)."""
        g = self.condition(params, coarse_mel, decoder_inp)
        return self.flow.p_losses(params["flownet"], self.target(gt_mel), t, g, x0)

    def sample(self, params: Params, coarse_mel: torch.Tensor, decoder_inp: torch.Tensor,
               noise: torch.Tensor, *, ucond_inp: torch.Tensor | None = None,
               cfg_scale: float = 1.0) -> torch.Tensor:
        """The refined mel [B, T, 80] from initial noise [B, T, 80]; with
        ``ucond_inp`` (an unconditional decoder_inp), classifier-free guidance
        at ``cfg_scale``."""
        g = self.condition(params, coarse_mel, decoder_inp)
        ucond = None if ucond_inp is None else self.condition(params, coarse_mel, ucond_inp)
        x = self.flow.sample(params["flownet"], g, noise, ucond=ucond, cfg_scale=cfg_scale)
        return denorm_spec(x, *self._spec_range(x.device))
