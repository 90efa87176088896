"""Conan acoustic model, inference side (``conan_tpu/models/conan/model.py``):
content codes + reference style → mel.

  content embedding → causal conv proj → + global style vector of the
  reference mel → + VQ prosody aligned onto the content by cross-attention →
  F0/UV head → pitch embedding → causal conv decoder → linear mel head. The
  F0 head is "orig" (direct regression) or "flow" (rectified flow from an
  initial noise, ``models/conan/flow.py``).

The reference utterance is whole before streaming starts, so its encoders run
once (``prepare_style``); the content → mel path is causal and streams chunk
by chunk with carried conv state (``stream_step``), equal to the matching
slice of ``apply``; with ``f0_gen="flow"`` the chunk's slice of the
utterance's initial noise goes in beside its codes.

``apply_train`` is the training forward: the ground-truth F0 drives the
pitch embedding, the F0 head is held to it by ``fdiff`` ("orig") or by the
rectified flow's velocity loss ``pflow`` ("flow"), and the VQ and the
aligner's forcing follow the schedule through device bools.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from conan_tpu_torch.audio.pitch import denorm_f0, f0_to_coarse
from conan_tpu_torch.models.conan.flow import (DiffNet, DiffNetConfig, RectifiedFlow,
                                               ReflowConfig, StreamingRectifiedFlow,
                                               minmax_denorm_f0, minmax_norm_f0)
from conan_tpu_torch.models.conan.prosody import LocalStyleAdaptor, ProsodyAligner
from conan_tpu_torch.nn.blocks import (ConvBlocks, PitchPredictor, embedding, init_conv,
                                       init_embedding, init_linear, linear,
                                       nonpadding_mask, positional_embedding)
from conan_tpu_torch.nn.module import Params, State, Stream
from conan_tpu_torch.ops.conv import causal_conv1d_state, conv1d
from conan_tpu_torch.parallel import dist


@dataclasses.dataclass(frozen=True)
class ConanConfig:
    hidden_size: int = 256
    kernel_size: int = 3
    n_mels: int = 80
    content_vocab: int = 102
    silent_token: int = 57
    style: bool = True
    use_spk_id: bool = False
    num_spk: int = 120
    n_vq: int = 512
    vae_dropout: float = 0.0
    lambda_commit: float = 0.25
    f0_gen: str = "orig"  # orig | flow
    predictor_kernel: int = 5
    predictor_grad: float = 1.0
    lambda_f0: float = 1.0
    dec_dilations: tuple[int, ...] = (1, 1, 1, 1)
    dec_kernel_size: int = 5
    dec_post_net_kernel: int = 3
    layers_in_block: int = 2
    dropout: float = 0.0
    f0_timesteps: int = 1000
    f0_k_step: int = 100
    f0_residual_layers: int = 10
    f0_residual_channels: int = 192
    f0_dilation_cycle_length: int = 4
    f0_sample_clip: bool = True
    max_source_positions: int = 2000

    @classmethod
    def from_hparams(cls, hp) -> "ConanConfig":
        return cls(
            hidden_size=hp["hidden_size"], kernel_size=hp["kernel_size"],
            n_mels=hp.get("audio_num_mel_bins", 80),
            content_vocab=hp.get("content_embedding_dim", 102),
            silent_token=hp["silent_token"], style=hp["style"],
            use_spk_id=hp.get("use_spk_id", False),
            num_spk=hp.get("num_spk", 120), n_vq=hp["nVQ"],
            vae_dropout=hp.get("vae_dropout", 0.0),
            lambda_commit=hp.get("lambda_commit", 0.25),
            f0_gen=hp["f0_gen"], predictor_kernel=hp["predictor_kernel"],
            predictor_grad=hp.get("predictor_grad", 1.0),
            lambda_f0=hp.get("lambda_f0", 1.0),
            dec_dilations=tuple(hp["dec_dilations"]),
            dec_kernel_size=hp["dec_kernel_size"],
            dec_post_net_kernel=hp.get("dec_post_net_kernel", 3),
            layers_in_block=hp["layers_in_block"], dropout=hp.get("dropout", 0.0),
            f0_timesteps=hp.get("f0_timesteps", 1000), f0_k_step=hp.get("f0_K_step", 100),
            f0_residual_layers=hp.get("f0_residual_layers", 10),
            f0_residual_channels=hp.get("f0_residual_channels", 192),
            f0_dilation_cycle_length=hp.get("f0_dilation_cycle_length", 4),
            f0_sample_clip=hp.get("f0_sample_clip", True),
        )


class Conan:
    def __init__(self, cfg: ConanConfig):
        if cfg.f0_gen not in ("orig", "flow"):
            raise ValueError(f"f0_gen {cfg.f0_gen!r} is neither 'orig' nor 'flow'")
        self.cfg = cfg
        H = cfg.hidden_size
        self.global_encoder = ConvBlocks(H, H, None, 31, layers_in_block=2, num_layers=5)
        self.decoder = ConvBlocks(H, H, cfg.dec_dilations, cfg.dec_kernel_size,
                                  layers_in_block=cfg.layers_in_block,
                                  post_net_kernel=cfg.dec_post_net_kernel, causal=True,
                                  dropout=cfg.dropout)
        self.uv_predictor = PitchPredictor(H, n_layers=5, n_chans=128, odim=2,
                                           kernel_size=cfg.predictor_kernel)
        if cfg.style:
            self.prosody = LocalStyleAdaptor(H, cfg.n_vq, cfg.vae_dropout, cfg.lambda_commit)
            self.aligner = ProsodyAligner(num_layers=2, hidden=H, nhead=2)
        if cfg.f0_gen == "flow":
            self.f0_net = DiffNet(DiffNetConfig(
                in_dims=1, encoder_hidden=H, residual_layers=cfg.f0_residual_layers,
                residual_channels=cfg.f0_residual_channels,
                dilation_cycle_length=cfg.f0_dilation_cycle_length))
            self.f0_flow = RectifiedFlow(self.f0_net, ReflowConfig(
                timesteps=cfg.f0_timesteps, k_step=cfg.f0_k_step,
                sample_clip=cfg.f0_sample_clip))
            self.f0_stream = StreamingRectifiedFlow(self.f0_flow)

    # ----------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Params:
        """Random parameters with the JAX package's tree and distributions."""
        cfg = self.cfg
        H = cfg.hidden_size
        p: Params = {
            "content_embedding": init_embedding(gen, cfg.content_vocab, H, std=1.0),
            "content_proj": init_conv(gen, H, H, cfg.kernel_size, init="kaiming_relu"),
            "global_conv_in": init_conv(gen, H, cfg.n_mels, 1),
            "global_encoder": self.global_encoder.init(gen),
            "uv_predictor": self.uv_predictor.init(gen),
            "pitch_embed": init_embedding(gen, 300, H, padding_idx=0),
            "decoder": self.decoder.init(gen),
            "mel_out": init_linear(gen, cfg.n_mels, H),
        }
        if cfg.style:
            p["prosody"] = self.prosody.init(gen)
            p["l1"] = init_linear(gen, H, 2 * H)
            p["aligner"] = self.aligner.init(gen)
        if cfg.use_spk_id:
            p["spk_id_proj"] = init_embedding(gen, cfg.num_spk, H)
        if cfg.f0_gen == "flow":
            p["f0_net"] = self.f0_net.init(gen)
        return p

    def init_vq_state(self, gen: torch.Generator) -> Params:
        return self.prosody.vq.init_state(gen)

    # ----------------------------------------------------------- style side
    def encode_spk_embed(self, params: Params, ref: torch.Tensor) -> torch.Tensor:
        """ref mel [B, T, 80] → global style vector [B, 1, H] (1×1 conv →
        5-layer k=31 ConvBlocks → masked mean)."""
        nonpad = nonpadding_mask(ref)
        x = conv1d(ref, params["global_conv_in"]["w"], params["global_conv_in"]["b"]) * nonpad
        x = self.global_encoder.apply(params["global_encoder"], x, nonpad) * nonpad
        denom = torch.clamp(torch.sum(nonpad, dim=1, keepdim=True), min=1.0)
        return torch.sum(x * nonpad, dim=1, keepdim=True) / denom

    def encode_prosody(self, params: Params, vq_state: Params,
                       ref: torch.Tensor) -> torch.Tensor:
        """ref mel [B, Tr, 80] → prosody keys [B, ceil(Tr/4), H]: quantized
        prosody + sinusoidal positions, through the concat projection."""
        return self._prosody_keys(params, self.prosody.apply(params["prosody"], vq_state, ref))

    def _prosody_keys(self, params: Params, pros: torch.Tensor) -> torch.Tensor:
        """Prosody + sinusoidal positions, through the concat projection."""
        positions = positional_embedding(pros[:, :, 0], self.cfg.hidden_size, padding_idx=0,
                                         max_positions=self.cfg.max_source_positions + 2)
        return linear(torch.cat([pros, positions.to(pros.dtype)], dim=-1), params["l1"])

    # ----------------------------------------------------------- pitch head
    def _pitch(self, params: Params, pitch_inp: torch.Tensor, content: torch.Tensor,
               s: Stream, noise: torch.Tensor | None):
        """(f0, uv): "orig" regresses log2-F0; "flow" integrates the rectified
        flow from ``noise`` [B, T, 1], offline over the whole utterance or,
        streaming, over the chunk with its K-stacked carries."""
        uv_pred = self.uv_predictor.apply(params["uv_predictor"], pitch_inp, stream=s)
        uv_b = (uv_pred[:, :, 0] > 0) | (content == self.cfg.silent_token)
        if self.cfg.f0_gen == "orig":
            return uv_pred[:, :, 1], uv_b.float()
        if s.streaming:
            f0_norm, s.new_state["f0_flow"] = self.f0_stream.step(
                params["f0_net"], s.state["f0_flow"], pitch_inp, noise)
        else:
            f0_norm = self.f0_flow.sample(params["f0_net"], pitch_inp, noise)
        return minmax_denorm_f0(f0_norm[..., 0], uv_b), uv_b.float()

    def _content_embed(self, params: Params, content: torch.Tensor, s: Stream) -> torch.Tensor:
        ce = embedding(torch.clamp(content, min=0), params["content_embedding"])
        ce = s.causal_conv("content_proj", ce, params["content_proj"], weight_norm=False)
        return F.leaky_relu(ce, 0.01)

    def sample_f0_noise(self, generator: torch.Generator, batch: int, length: int,
                        device: torch.device | str = "cpu") -> torch.Tensor:
        """The rectified flow's initial noise for one utterance, [B, length, 1]
        standard normal, drawn from ``generator`` on the CPU and then moved to
        ``device``: one seed gives the same noise on every device. (The JAX
        package draws it from its own key; the port does not reproduce that
        stream.) A stream slices it chunk by chunk, so streaming and offline
        integrate from the same x0."""
        return dist.randn((batch, length, 1), generator).to(device)

    # ----------------------------------------------------------- forward
    def apply(self, params: Params, content: torch.Tensor, *, ref: torch.Tensor,
              vq_state: Params | None = None,
              initial_noise: torch.Tensor | None = None) -> dict:
        """Offline inference over a whole utterance: content [B, T] int codes,
        ref [B, Tr, 80] reference mel → {"mel_out": [B, T, 80],
        "f0_denorm_pred": [B, T]}. ``f0_gen="flow"`` needs ``initial_noise``
        [B, T, 1] (``sample_f0_noise``)."""
        return self.decode(params, content, self.prepare_style(params, vq_state, ref),
                           initial_noise=initial_noise)

    def decode(self, params: Params, content: torch.Tensor, style_ctx: dict,
               initial_noise: torch.Tensor | None = None) -> dict:
        """Offline inference against a style context from ``prepare_style``,
        so a caller can prepare the style under another precision than the
        decoding."""
        if self.cfg.f0_gen == "flow" and initial_noise is None:
            raise ValueError("f0_gen='flow' decodes from an initial noise: pass "
                             "initial_noise (sample_f0_noise)")
        return self._forward(params, content, style_ctx, Stream(None), initial_noise)

    def _forward(self, params: Params, content: torch.Tensor, style_ctx: dict,
                 s: Stream, noise: torch.Tensor | None) -> dict:
        pitch_inp = self._content_embed(params, content, s) + style_ctx["style"]
        if self.cfg.style:
            pitch_inp = pitch_inp + self.aligner.apply(
                params["aligner"], pitch_inp, style_ctx["prosody"], style_ctx["prosody_pad"])
        f0_out, uv_out = self._pitch(params, pitch_inp, content, s, noise)
        f0_denorm = denorm_f0(f0_out, uv_out)
        pe = embedding(f0_to_coarse(f0_denorm), params["pitch_embed"])
        dec_inp = pitch_inp + pe
        x = self.decoder.apply(params["decoder"], dec_inp, torch.ones_like(dec_inp[..., :1]),
                               stream=s)
        return {"mel_out": linear(x, params["mel_out"]), "f0_denorm_pred": f0_denorm}

    # ----------------------------------------------------------- training
    def apply_train(self, params: Params, vq_state: Params | None, content: torch.Tensor,
                    ref: torch.Tensor, f0: torch.Tensor, uv: torch.Tensor, *,
                    global_step: torch.Tensor, vq_start: int, forcing_steps: int,
                    generator: torch.Generator | None = None,
                    spk_embed: torch.Tensor | None = None,
                    spk_id: torch.Tensor | None = None) -> dict:
        """The training forward: content [B, T] codes (-1 pads), ref
        [B, Tr, 80], ground-truth log2-F0 and UV [B, T] → {"mel_out",
        "decoder_inp", "uv_pred", "fdiff" ("orig") or "pflow" ("flow"),
        "f0_denorm_pred", and with style "vq_loss", "ppl", "gloss", "attn",
        "vq_state"}. The VQ quantizes once ``global_step > vq_start`` and the
        aligner is forced while ``global_step < forcing_steps``, both decided
        on the device; the VQ state in the output is the EMA-updated one (not
        detached). With a ``generator``, dropout as the JAX package trains;
        the flow F0 loss draws its step and noise from it (``f0_flow.draws``;
        None: a CPU generator seeded 0). The style is ``spk_embed`` [B, H] or
        [B, 1, H] where given (a pre-extracted embedding, Conan.py:146-149),
        else the reference encoder's; with ``use_spk_id`` and ``spk_id`` [B]
        the speaker's id embedding is added to it (fs.py:101-117)."""
        cfg = self.cfg
        ret: dict = {}
        ce = self._content_embed(params, content, Stream(None))
        if spk_embed is not None:
            style = spk_embed if spk_embed.dim() == 3 else spk_embed[:, None, :]
        else:
            style = self.encode_spk_embed(params, ref)
        if cfg.use_spk_id and spk_id is not None:
            style = style + embedding(spk_id, params["spk_id_proj"])[:, None, :]
        pitch_inp = ce + style
        if cfg.style:
            pros, ret["vq_loss"], ret["ppl"], ret["vq_state"] = self.prosody.apply_train(
                params["prosody"], vq_state, ref, use_vq=global_step > vq_start,
                generator=generator)
            pros = self._prosody_keys(params, pros)
            aligned, ret["gloss"], ret["attn"] = self.aligner.apply_train(
                params["aligner"], pitch_inp, pros, pitch_inp[:, :, 0] == 0.0,
                pros[:, :, 0] == 0.0, forcing=global_step < forcing_steps,
                generator=generator)
            pitch_inp = pitch_inp + aligned
        pitch_inp_p = pitch_inp
        if cfg.predictor_grad != 1.0:
            pitch_inp_p = pitch_inp.detach() + cfg.predictor_grad * (pitch_inp
                                                                      - pitch_inp.detach())
        ret["uv_pred"] = self.uv_predictor.apply(params["uv_predictor"], pitch_inp_p,
                                                 generator=generator)
        voiced = (uv == 0).to(pitch_inp.dtype)
        if cfg.f0_gen == "flow":
            # the velocity loss on the minmax-normalized log2-F0, voiced frames only
            x1 = minmax_norm_f0(f0, uv)[..., None]
            t, x0 = self.f0_flow.draws(x1, generator)
            ret["pflow"] = self.f0_flow.p_losses(params["f0_net"], x1, t, pitch_inp_p, x0,
                                                 generator=generator, nonpadding=voiced)
        else:
            ret["fdiff"] = (torch.sum(torch.square(ret["uv_pred"][:, :, 1] - f0) * voiced)
                            / dist.global_count(voiced.sum()).clamp(min=1.0)) * cfg.lambda_f0
        f0_denorm = denorm_f0(f0, uv)
        ret["f0_denorm_pred"] = f0_denorm
        dec_inp = pitch_inp + embedding(f0_to_coarse(f0_denorm), params["pitch_embed"])
        ret["decoder_inp"] = dec_inp
        x = self.decoder.apply(params["decoder"], dec_inp, torch.ones_like(dec_inp[..., :1]),
                               generator=generator)
        ret["mel_out"] = linear(x, params["mel_out"])
        return ret

    # ----------------------------------------------------------- streaming
    def prepare_style(self, params: Params, vq_state: Params | None,
                      ref: torch.Tensor) -> dict:
        """Everything derived from the reference utterance, computed once
        before streaming starts."""
        out = {"style": self.encode_spk_embed(params, ref)}
        if self.cfg.style:
            pros = self.encode_prosody(params, vq_state, ref)
            out["prosody"] = pros
            out["prosody_pad"] = pros[:, :, 0] == 0.0
        return out

    def init_stream_state(self, batch: int, device: torch.device | str = "cpu") -> State:
        st: State = {"content_proj": causal_conv1d_state(
            batch, self.cfg.hidden_size, self.cfg.kernel_size, 1, device=device)}
        st.update(self.uv_predictor.init_state(batch, "pp", device=device))
        st.update(self.decoder.init_state(batch, device=device))
        if self.cfg.f0_gen == "flow":
            st["f0_flow"] = self.f0_stream.init_state(batch, device=device)
        return st

    def stream_step(self, params: Params, state: State, content_chunk: torch.Tensor,
                    style_ctx: dict, f0_noise: torch.Tensor | None = None
                    ) -> tuple[dict, State]:
        """One causal chunk step: [B, Tc] codes → ({"mel_out": [B, Tc, 80],
        "f0_denorm_pred": [B, Tc]}, state'). Equals the matching slice of
        ``apply``: the aligner works per query row and every other op is
        causal. ``f0_noise`` [B, Tc, 1] is this chunk's slice of the
        utterance's initial noise (``f0_gen="flow"`` only; zeros if None,
        deterministic but not the distribution the flow was trained from)."""
        if self.cfg.f0_gen == "flow" and f0_noise is None:
            f0_noise = torch.zeros(*content_chunk.shape, 1, device=content_chunk.device)
        s = Stream(state)
        return self._forward(params, content_chunk, style_ctx, s, f0_noise), s.new_state
