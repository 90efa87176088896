"""The original, non-causal HiFi-GAN generator
(``conan_tpu/models/vocoder/hifigan_noncausal.py``), registered as
``HifiGAN_noncausal``: transposed-conv upsampling and resblock convs padded
on both sides. It has ``init`` and ``apply`` and no streaming step: its
output depends on future frames, so it serves offline synthesis and
copy-synthesis only. Parameter trees are the JAX package's (``ups`` holds
the weight-normed transposed convs themselves).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from conan_tpu_torch.checkpoint import params_from_state_dict, state_dict_from_params
from conan_tpu_torch.models.vocoder.hifigan import (HifiGanConfig, _lrelu, check_config,
                                                    init_resblocks, init_wn_deconv, resblock_names,
                                                    wn_names)
from conan_tpu_torch.nn.blocks import init_wn_conv
from conan_tpu_torch.nn.module import Params
from conan_tpu_torch.ops.conv import conv1d, conv_transpose1d, weight_norm_weight


def wn_conv(x: torch.Tensor, p: Params, *, dilation: int = 1, pad: int = 0) -> torch.Tensor:
    """A weight-normed conv padded by ``pad`` frames on both sides."""
    return conv1d(x, weight_norm_weight(p), p["b"], dilation=dilation, padding=(pad, pad))


class NonCausalHifiGanGenerator:
    def __init__(self, cfg: HifiGanConfig, c_out: int = 1):
        check_config(cfg)
        self.cfg = cfg
        self.c_out = c_out
        chs = [cfg.upsample_initial_channel]
        for _ in cfg.upsample_rates:
            chs.append(chs[-1] // 2)
        self.channels = chs

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters: weight-normed convs with v ~ N(0, 0.01)."""
        cfg = self.cfg
        ups, resblocks = [], []
        conv_pre = init_wn_conv(gen, cfg.upsample_initial_channel, cfg.num_mels, 7, std=0.01)
        for i, k in enumerate(cfg.upsample_kernel_sizes):
            ups.append(init_wn_deconv(gen, self.channels[i], self.channels[i + 1], k))
            resblocks += init_resblocks(gen, cfg, self.channels[i + 1])
        return {"conv_pre": conv_pre, "ups": ups, "resblocks": resblocks,
                "conv_post": init_wn_conv(gen, self.c_out, self.channels[-1], 7, std=0.01)}

    def torch_names(self) -> Params:
        """The reference generator's key of each leaf: conv_pre, ups.{i},
        resblocks.{i}.convs{1,2}.{j}, conv_post (``checkpoint.py``)."""
        return {"conv_pre": wn_names("conv_pre"),
                "ups": [wn_names(f"ups.{i}") for i in range(len(self.cfg.upsample_rates))],
                "resblocks": resblock_names(self.cfg), "conv_post": wn_names("conv_post")}

    def params_from_torch(self, sd, device=None) -> Params:
        """A reference state dict (tensors or numpy arrays) → params on
        ``device`` (None: the card)."""
        return params_from_state_dict(sd, self.torch_names(), device)

    def params_to_torch(self, params: Params) -> dict[str, torch.Tensor]:
        return state_dict_from_params(params, self.torch_names())

    def _resblock(self, p: Params, x: torch.Tensor, rk: int, dilations) -> torch.Tensor:
        for j, d in enumerate(dilations):
            if self.cfg.resblock == "1":
                xt = wn_conv(_lrelu(x), p["convs1"][j], dilation=d, pad=d * (rk - 1) // 2)
                x = x + wn_conv(_lrelu(xt), p["convs2"][j], pad=(rk - 1) // 2)
            else:
                x = x + wn_conv(_lrelu(x), p["convs"][j], dilation=d, pad=d * (rk - 1) // 2)
        return x

    def _stages(self, params: Params, x: torch.Tensor, source=None) -> torch.Tensor:
        """conv_pre, the upsampling stages, conv_post and tanh; ``source(i, x)``
        (the NSF generator's) is added after stage i's upsampler."""
        cfg = self.cfg
        x = wn_conv(x, params["conv_pre"], pad=3)
        n_rb = len(cfg.resblock_kernel_sizes)
        rb = 0
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            up = params["ups"][i]
            x = conv_transpose1d(_lrelu(x), weight_norm_weight(up), up["b"], stride=u,
                                 padding=(k - u) // 2)
            if source is not None:
                x = x + source(i, x)
            xs = None
            for j in range(n_rb):
                y = self._resblock(params["resblocks"][rb], x, cfg.resblock_kernel_sizes[j],
                                   cfg.resblock_dilation_sizes[j])
                xs = y if xs is None else xs + y
                rb += 1
            x = xs / n_rb
        # the reference's last leaky ReLU takes torch's default slope
        x = wn_conv(F.leaky_relu(x, 0.01), params["conv_post"], pad=3)
        return torch.tanh(x)

    def apply(self, params: Params, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, num_mels] → wav [B, T·stride, c_out]."""
        return self._stages(params, mel)
