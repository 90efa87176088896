"""Engine composition from trained checkpoints (``conan_tpu/infer/build.py``).

Three separately trained checkpoint dirs (acoustic model, Emformer, vocoder),
each with its own ``config.yaml``, in the JAX package's checkpoint format,
and the vocoder registry (``conan_tpu/infer/build.py:24-44``): ``HifiGAN``
(the causal generator, the one that streams), ``HifiGAN_noncausal`` and
``HifiGAN_NSF``.
"""

from __future__ import annotations

import os

import torch
import yaml

from conan_tpu_torch.audio.mel import MelConfig
from conan_tpu_torch.checkpoint import load_ckpt_state, params_from_jax, save_checkpoint
from conan_tpu_torch.config import HParams, load_config
from conan_tpu_torch.device import resolve_device
from conan_tpu_torch.infer.streaming import StreamingConfig, StreamingVoiceConversion
from conan_tpu_torch.models.conan.model import Conan, ConanConfig
from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
from conan_tpu_torch.models.vocoder.hifigan_noncausal import NonCausalHifiGanGenerator
from conan_tpu_torch.models.vocoder.hifigan_nsf import NsfHifiGanGenerator

VOCODER_REGISTRY: dict[str, type] = {}


def register_vocoder(name: str):
    def deco(cls):
        VOCODER_REGISTRY[name] = cls
        return cls
    return deco


def get_vocoder_cls(name: str):
    return VOCODER_REGISTRY[name]


register_vocoder("HifiGAN")(HifiGanGenerator)
register_vocoder("HifiGAN_noncausal")(NonCausalHifiGanGenerator)
register_vocoder("HifiGAN_NSF")(NsfHifiGanGenerator)


def streamable(gen) -> bool:
    """Whether a generator has a streaming ``step``: the causal one, unless
    its upsampler is the transposed conv ("nn")."""
    return isinstance(gen, HifiGanGenerator) and gen.cfg.upsample != "nn"


def _load_dir_config(ckpt_dir: str) -> HParams:
    cfg_path = os.path.join(ckpt_dir, "config.yaml")
    if os.path.exists(cfg_path):
        return HParams(load_config(cfg_path))
    return HParams({})


def build_engine(conan_dir: str, emformer_dir: str, vocoder_dir: str,
                 hp: HParams | None = None, serving_precision: str | None = None,
                 device: str | torch.device | None = None) -> StreamingVoiceConversion:
    """Load the three stage checkpoints and build the streaming engine on
    ``device`` (None: the CUDA card; raises if there is none).

    ``serving_precision`` None takes the acoustic checkpoint's
    ``serving_precision`` hparam if it has one, else "exact"; an explicit
    value, "exact" included, always wins. The engine streams, so the
    acoustic checkpoint's ``vocoder`` hparam must name the causal "HifiGAN"
    and the vocoder's config an upsampler other than "nn"; any other
    generator raises NotImplementedError as not streamable."""
    device = resolve_device(device)
    conan_state = load_ckpt_state(conan_dir)
    hp_conan = hp or _load_dir_config(conan_dir)
    vocoder = hp_conan.get("vocoder") or "HifiGAN"
    hp_emf = _load_dir_config(emformer_dir)
    hp_voc = _load_dir_config(vocoder_dir)
    voc_cfg = HifiGanConfig.from_hparams(hp_voc) if "upsample_rates" in hp_voc \
        else HifiGanConfig()
    if not streamable(get_vocoder_cls(vocoder)(voc_cfg)):
        raise NotImplementedError(
            f"vocoder {vocoder!r} (upsample {voc_cfg.upsample!r}) is not streamable: the "
            "engine's chunk step needs the causal HifiGAN with a 'shuffle' or 'zero' "
            "upsampler")
    cfg = StreamingConfig(
        mel=MelConfig.from_hparams(hp_conan) if "hop_size" in hp_conan else MelConfig(),
        emformer=(EmformerConfig.from_hparams(hp_emf)
                  if "emformer_layers" in hp_emf else EmformerConfig()),
        conan=(ConanConfig.from_hparams(hp_conan)
               if "hidden_size" in hp_conan else ConanConfig()),
        vocoder=voc_cfg,
    )
    if serving_precision is None:
        serving_precision = str(hp_conan.get("serving_precision") or "exact")
    vq_state = conan_state.get("vq_state")
    return StreamingVoiceConversion(
        cfg,
        params_from_jax(load_ckpt_state(emformer_dir, "params"), device),
        params_from_jax(conan_state["params_g"], device),
        params_from_jax(vq_state, device) if vq_state is not None else None,
        params_from_jax(load_ckpt_state(vocoder_dir, "params_g"), device),
        serving_precision=serving_precision, device=device,
    )


def write_random_checkpoints(root: str, hparams: dict, seed: int = 0) -> tuple[str, str, str]:
    """Seeded random weights for the three stages, written as checkpoint dirs
    (``config.yaml`` and one checkpoint each) under ``root``, for smoke runs
    where no trained checkpoints are at hand. ``hparams`` maps "conan",
    "emformer" and "vocoder" to each stage's config dict. Returns the dirs in
    ``build_engine``'s order: (conan, emformer, vocoder)."""
    gen = torch.Generator().manual_seed(seed)
    hp = {k: HParams(v) for k, v in hparams.items()}
    conan = Conan(ConanConfig.from_hparams(hp["conan"]))
    emformer = EmformerDistillModel(EmformerConfig.from_hparams(hp["emformer"]))
    vocoder = HifiGanGenerator(HifiGanConfig.from_hparams(hp["vocoder"]))
    states = {"conan": {"params_g": conan.init(gen), "vq_state": conan.init_vq_state(gen)},
              "emformer": {"params": emformer.init(gen)},
              "vocoder": {"params_g": vocoder.init(gen)}}
    dirs = []
    for name in ("conan", "emformer", "vocoder"):
        d = os.path.join(root, name)
        save_checkpoint(d, 0, states[name], hparams[name])
        with open(os.path.join(d, "config.yaml"), "w") as f:
            yaml.safe_dump(dict(hparams[name]), f)
        dirs.append(d)
    return tuple(dirs)
