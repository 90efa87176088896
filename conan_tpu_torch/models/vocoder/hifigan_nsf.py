"""NSF HiFi-GAN (``conan_tpu/models/vocoder/hifigan_nsf.py``), registered as
``HifiGAN_NSF``: the non-causal HiFi-GAN with a harmonic-plus-noise source
(8 harmonics of F0, ``sine_gen``) merged by a linear + tanh and added after
every upsampler through a strided conv. Offline only, like its base.

The random parts, each harmonic's initial phase and the additive noise, are
drawn from a ``torch.Generator`` on the device (not ``jax.random``'s stream);
``deterministic=True`` draws nothing, and ``f0=None`` skips the source.
"""

from __future__ import annotations

import math

import torch

from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig
from conan_tpu_torch.models.vocoder.hifigan_noncausal import NonCausalHifiGanGenerator
from conan_tpu_torch.nn.blocks import init_conv, init_linear, linear
from conan_tpu_torch.nn.module import Params
from conan_tpu_torch.ops.conv import conv1d


def sine_gen(f0: torch.Tensor, generator: torch.Generator | None = None, *, sample_rate: int,
             harmonic_num: int = 8, sine_amp: float = 0.1, noise_std: float = 0.003,
             voiced_threshold: float = 0.0, deterministic: bool = False,
             rand_ini: torch.Tensor | None = None, noise_normal: torch.Tensor | None = None):
    """SineGen.forward (source.py:103-136). f0 [B, T, 1] Hz at the audio rate
    → (sine waves [B, T, H+1] with the noise added, uv [B, T, 1], noise).

    The phase is the cumulative sum of f0·h / sample_rate with the
    reference's overflow compensation (a -1 wherever the wrapped running sum
    wraps), computed as the JAX package computes it. Unless
    ``deterministic``, each harmonic but the first starts at a uniform
    random phase and the noise is normal; both are drawn from ``generator``
    unless given (``rand_ini`` [B, H+1], whose column 0 is ignored, and
    ``noise_normal`` [B, T, H+1], before its per-sample amplitude)."""
    B, T, _ = f0.shape
    dim = harmonic_num + 1
    mult = torch.arange(1, dim + 1, dtype=torch.float32, device=f0.device)
    rad = torch.remainder(f0 * mult / sample_rate, 1.0)
    if not deterministic:
        if rand_ini is None:
            rand_ini = torch.rand(B, dim, generator=generator, device=f0.device)
        rand_ini = torch.cat([torch.zeros_like(rand_ini[:, :1]), rand_ini[:, 1:]], dim=1)
        rad = torch.cat([rad[:, :1] + rand_ini[:, None], rad[:, 1:]], dim=1)
    tmp = torch.remainder(torch.cumsum(rad, dim=1), 1.0)
    over = torch.zeros_like(tmp, dtype=torch.bool)
    over[:, 1:] = (tmp[:, 1:] - tmp[:, :-1]) < 0
    shift = torch.where(over, -1.0, 0.0)
    sine_waves = torch.sin(torch.cumsum(rad + shift, dim=1) * 2 * math.pi) * sine_amp
    uv = (f0 > voiced_threshold).float()
    noise_amp = uv * noise_std + (1 - uv) * sine_amp / 3
    if deterministic:
        noise = torch.zeros_like(sine_waves)
    else:
        if noise_normal is None:
            noise_normal = torch.randn(sine_waves.shape, generator=generator, device=f0.device)
        noise = noise_amp * noise_normal
    return sine_waves * uv + noise, uv, noise


class NsfHifiGanGenerator(NonCausalHifiGanGenerator):
    """The non-causal HiFi-GAN plus a harmonic source injected at every level."""

    HARMONIC_NUM = 8

    def __init__(self, cfg: HifiGanConfig, sample_rate: int = 16000, c_out: int = 1):
        super().__init__(cfg, c_out)
        self.sample_rate = sample_rate

    def _noise_strides(self) -> list[int]:
        """Stage i's source conv stride: the product of the later rates (1 last)."""
        rates = self.cfg.upsample_rates
        return [math.prod(rates[i + 1:]) for i in range(len(rates))]

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters; each ``noise_convs`` entry carries its stride as
        an int leaf, as the JAX package's tree does."""
        p = super().init(gen)
        p["source_linear"] = init_linear(gen, 1, self.HARMONIC_NUM + 1)
        last = len(self.cfg.upsample_rates) - 1
        p["noise_convs"] = [{"conv": init_conv(gen, self.channels[i + 1], 1,
                                               1 if i == last else stride * 2),
                             "stride": stride}
                            for i, stride in enumerate(self._noise_strides())]
        return p

    def torch_names(self) -> Params:
        """The non-causal generator's keys, plus m_source.l_linear and
        noise_convs.{i}; each noise conv's stride stays an int leaf."""
        p = super().torch_names()
        p["source_linear"] = {"w": "m_source.l_linear.weight", "b": "m_source.l_linear.bias"}
        p["noise_convs"] = [{"conv": {"w": f"noise_convs.{i}.weight",
                                      "b": f"noise_convs.{i}.bias"}, "stride": stride}
                            for i, stride in enumerate(self._noise_strides())]
        return p

    def apply(self, params: Params, mel: torch.Tensor, f0: torch.Tensor | None = None,
              generator: torch.Generator | None = None, deterministic: bool = False,
              **draws) -> torch.Tensor:
        """mel [B, T, 80], f0 [B, T] frame-rate Hz (None: no harmonic source)
        → wav [B, T·stride, c_out]. ``draws`` (``rand_ini``, ``noise_normal``)
        go to ``sine_gen``."""
        source = None
        if f0 is not None:
            f0_up = torch.repeat_interleave(f0, self.cfg.total_stride, dim=1)[..., None]
            sine_waves, _, _ = sine_gen(f0_up, generator, sample_rate=self.sample_rate,
                                        harmonic_num=self.HARMONIC_NUM,
                                        deterministic=deterministic, **draws)
            har = torch.tanh(linear(sine_waves, params["source_linear"]))      # [B, Ta, 1]

            def source(i: int, x: torch.Tensor) -> torch.Tensor:
                nc = params["noise_convs"][i]
                stride = self._noise_strides()[i]
                pad = stride // 2 if stride > 1 else 0
                return conv1d(har, nc["conv"]["w"], nc["conv"]["b"], stride=stride,
                              padding=(pad, pad))[:, :x.shape[1]]
        return self._stages(params, mel, source)
