"""Streaming voice-conversion engine (``conan_tpu/infer/streaming.py``).

Per 80 ms chunk: Emformer K/V-cache step → argmax content codes → Conan
acoustic chunk step → vocoder chunk step, each with carried state, so the
work per chunk is O(chunk) and the output equals the offline composition of
the three stages. All state stays on the device between chunks; the wav
chunks are gathered on the device and copied to the host once.

Two chunk loops run the same step. ``infer_once`` by default runs it from a
Python loop, chunk by chunk, the shape of live streaming. ``use_scan=True``
runs ``stream_scan``, the counterpart of the JAX package's ``lax.scan``: on
the card the chunk step is captured once into a CUDA graph over static
buffers and replayed once per chunk, so a chunk costs one graph launch
instead of hundreds of kernel launches from the host; on the CPU it is the
same Python loop. ``bucket_lengths=True`` pads the source, on the scan path,
to power-of-two lengths, so that a batch of recordings of many lengths needs
few captures; the padding never changes the output (every source-side op is
causal and the pad repeats the last frame). The reference is never padded:
the JAX package pads it too, and its zero frames move the output wherever
the reference encoders' LayerNorm biases are nonzero, as in trained weights
(LN turns each zero frame into its bias, which the k=31 and k=5 convs of the
last real frames read). So each distinct reference length is one more
capture of the chunk step.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from conan_tpu_torch.audio.mel import MelConfig, wav2mel_frontend
from conan_tpu_torch.checkpoint import tree_leaves, tree_map
from conan_tpu_torch.device import resolve_device
from conan_tpu_torch.models.conan.model import Conan, ConanConfig
from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
from conan_tpu_torch.ops.conv import fold_weight_norm
from conan_tpu_torch.ops.precision import PRECISIONS, precision_scope


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    mel: MelConfig = MelConfig()
    emformer: EmformerConfig = EmformerConfig()
    conan: ConanConfig = ConanConfig()
    vocoder: HifiGanConfig = HifiGanConfig()

    @property
    def seg(self) -> int:
        return self.emformer.segment_length

    @property
    def rc(self) -> int:
        return self.emformer.right_context_length


class StreamingVoiceConversion:
    """Batched engine: B concurrent conversions per chunk step.

    Parameters are trees of tensors (``checkpoint.params_from_jax``); they are
    moved to ``device`` (None: the CUDA card) and weight norm is folded once.

    ``serving_precision`` ("exact" default, "high", "fast", see
    ``ops/precision.py``) applies to the acoustic model and the vocoder, in
    streaming and offline alike; the Emformer and the style preparation run
    in fp32 ("exact") on every rung.

    With ``f0_gen="flow"`` every entry point draws the utterance's initial
    F0 noise from ``generator`` (None: a generator seeded 0) at the padded
    source length, or takes it as ``f0_noise`` [B, T_pad, 1]; streaming and
    offline integrate the flow from the same noise when their T_pad agrees.
    """

    def __init__(self, cfg: StreamingConfig, emformer_params, conan_params,
                 conan_vq_state, vocoder_params, serving_precision: str = "exact",
                 device: str | torch.device | None = None):
        if serving_precision not in PRECISIONS:
            raise ValueError(f"serving_precision {serving_precision!r} not in {PRECISIONS}")
        self.serving_precision = serving_precision
        self.device = resolve_device(device)
        self.cfg = cfg
        self.emformer = EmformerDistillModel(cfg.emformer)
        self.conan = Conan(cfg.conan)
        self.vocoder = HifiGanGenerator(cfg.vocoder)

        def to_dev(tree):
            return tree_map(lambda x: x.to(self.device), tree)

        self.p_emformer = to_dev(emformer_params)
        self.p_conan = fold_weight_norm(to_dev(conan_params))
        self.vq_state = to_dev(conan_vq_state) if conan_vq_state is not None else None
        self.p_vocoder = fold_weight_norm(to_dev(vocoder_params))
        self._captured: dict = {}

    # ------------------------------------------------------------------
    def _prepare(self, ref_mel: torch.Tensor) -> dict:
        with precision_scope("exact", self.device):
            return self.conan.prepare_style(self.p_conan, self.vq_state, ref_mel)

    def init_state(self, batch: int) -> dict:
        return {"emformer": self.emformer.init_state(batch, self.device),
                "conan": self.conan.init_stream_state(batch, self.device),
                "vocoder": self.vocoder.init_state(batch, self.device)}

    def _chunk_step(self, state: dict, mel_chunk: torch.Tensor, style_ctx: dict,
                    f0_noise: torch.Tensor | None = None):
        """mel_chunk [B, seg+rc, 80], f0_noise [B, seg, 1] (this chunk's slice
        of the utterance's flow noise; unused unless f0_gen="flow") → (wav
        [B, seg·hop, 1] fp32, codes [B, seg], state'). The three stages are
        profiler ranges "stage:<name>"."""
        with precision_scope("exact", self.device), record_function("stage:emformer"):
            logits, em_state = self.emformer.step(self.p_emformer, state["emformer"],
                                                  mel_chunk)
            codes = torch.argmax(logits, dim=-1)
        with precision_scope(self.serving_precision, self.device):
            with record_function("stage:conan"):
                ret, conan_state = self.conan.stream_step(self.p_conan, state["conan"],
                                                          codes, style_ctx, f0_noise)
            with record_function("stage:vocoder"):
                wav, voc_state = self.vocoder.step(self.p_vocoder, state["vocoder"],
                                                   ret["mel_out"])
        return wav.float(), codes, {"emformer": em_state, "conan": conan_state,
                                    "vocoder": voc_state}

    @torch.inference_mode()
    def stream_scan(self, state: dict, mel_chunks: torch.Tensor, style_ctx: dict,
                    f0_noise_chunks: torch.Tensor | None = None):
        """N chunk steps with no host work per chunk beyond a graph launch:
        mel_chunks [N, B, seg+rc, 80] (and f0_noise_chunks [N, B, seg, 1]) →
        (wavs [N, B, seg·hop, 1], codes [N, B, seg], final state).

        On the card the step is captured into a CUDA graph once per shape of
        its inputs (B and the prosody length; the rung and f0_gen are the
        engine's) and cached on the engine. Each call refills the graph's
        static state from ``state``, so one call never continues another's
        utterance. A capture or replay error raises; nothing falls back to
        the eager loop. On the CPU the step runs from a Python loop."""
        N, B = mel_chunks.shape[:2]
        if f0_noise_chunks is None:
            f0_noise_chunks = torch.zeros(N, B, self.cfg.seg, 1, device=mel_chunks.device)
        if self.device.type == "cuda":
            step = self._captured_step(state, mel_chunks[0], style_ctx, f0_noise_chunks[0])
            return step.run(state, mel_chunks, style_ctx, f0_noise_chunks)
        return self._eager_loop(state, mel_chunks, style_ctx, f0_noise_chunks)

    def _eager_loop(self, state: dict, mel_chunks: torch.Tensor, style_ctx: dict,
                    f0_noise_chunks: torch.Tensor):
        """``stream_scan``'s chunk steps launched from a Python loop, chunk by
        chunk (the shape of live streaming); same arguments and return."""
        wavs, codes = [], []
        for mel_chunk, noise_chunk in zip(mel_chunks, f0_noise_chunks, strict=True):
            wav, c, state = self._chunk_step(state, mel_chunk, style_ctx, noise_chunk)
            wavs.append(wav)
            codes.append(c)
        return torch.stack(wavs), torch.stack(codes), state

    def _captured_step(self, state: dict, mel_chunk: torch.Tensor, style_ctx: dict,
                       f0_noise: torch.Tensor) -> "CapturedChunkStep":
        """The chunk step's CUDA graph for these input shapes, captured on
        first use."""
        key = tuple(tuple(x.shape) for x in [mel_chunk, *tree_leaves(style_ctx)])
        if key not in self._captured:
            self._captured[key] = CapturedChunkStep(self._chunk_step, state, mel_chunk,
                                                    style_ctx, f0_noise)
        return self._captured[key]

    # ------------------------------------------------------------------
    def wav_to_mel(self, wav) -> torch.Tensor:
        """Feature frontend: wav [T] or [B, T] (numpy or tensor) → [B, frames, 80]
        on the engine's device."""
        wav = torch.as_tensor(wav, dtype=torch.float32)
        if wav.dim() == 1:
            wav = wav[None]
        return wav2mel_frontend(wav.to(self.device).contiguous(), self.cfg.mel)

    @staticmethod
    def _p2bucket(n: int, lo: int = 64) -> int:
        b = lo
        while b < n:
            b *= 2
        return b

    def _source_chunks(self, src_mel: torch.Tensor, bucket_lengths: bool = False):
        """Pad the source mel so its length is a segment multiple (with
        ``bucket_lengths`` the next rung of the power-of-two ladder), plus the
        rc-frame lookahead tail, by repeating the last frame (every source-side
        op is causal, so the first T frames' output does not change)."""
        seg, rc = self.cfg.seg, self.cfg.rc
        T = src_mel.shape[1]
        T_pad = -(-T // seg) * seg
        if bucket_lengths:
            T_pad = self._p2bucket(T_pad)
        tail = src_mel[:, -1:].expand(-1, T_pad - T + rc, -1)
        return torch.cat([src_mel, tail], dim=1), T, T_pad

    def _f0_noise(self, batch: int, T_pad: int, generator: torch.Generator | None,
                  f0_noise) -> torch.Tensor:
        """The utterance's flow noise [B, T_pad, 1] on the device: ``f0_noise``
        as given, else drawn from ``generator`` (None: seeded 0); zeros for
        f0_gen="orig", which does not read it."""
        if f0_noise is not None:
            noise = torch.as_tensor(f0_noise, dtype=torch.float32).to(self.device)
            if tuple(noise.shape) != (batch, T_pad, 1):
                raise ValueError(f"f0_noise shape {tuple(noise.shape)} != {(batch, T_pad, 1)} "
                                 "(B, padded source length, 1)")
            return noise
        if self.cfg.conan.f0_gen != "flow":
            return torch.zeros(batch, T_pad, 1, device=self.device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        return self.conan.sample_f0_noise(gen, batch, T_pad, self.device)

    def scan_inputs(self, mel_ext: torch.Tensor, noise: torch.Tensor):
        """The padded source mel [B, T_pad+rc, 80] and noise [B, T_pad, 1] as
        ``stream_scan``'s chunks: ([N, B, seg+rc, 80], [N, B, seg, 1])."""
        seg, rc = self.cfg.seg, self.cfg.rc
        B, T_pad = noise.shape[:2]
        chunks = mel_ext.unfold(1, seg + rc, seg).permute(1, 0, 3, 2).contiguous()
        return chunks, noise.reshape(B, T_pad // seg, seg, 1).transpose(0, 1).contiguous()

    @torch.inference_mode()
    def infer_once(self, src_wav, ref_wav, collect_codes: bool = False,
                   use_scan: bool = False, bucket_lengths: bool = False,
                   generator: torch.Generator | None = None, f0_noise=None):
        """Streaming conversion of one utterance (or a batch): the source mel
        is computed up front and consumed chunk by chunk; the reference mel is
        whole before streaming starts. ``use_scan`` runs the chunks through
        ``stream_scan`` (the captured loop on the card), else through the
        Python loop; ``bucket_lengths`` pads the source on the scan path to
        the power-of-two ladder, never the reference (see the module's
        docstring). Returns the wav [B, T·hop] as
        numpy (and the codes [B, T] with ``collect_codes``)."""
        src_mel = self.wav_to_mel(src_wav)
        style_ctx = self._prepare(self.wav_to_mel(ref_wav))
        mel_ext, T, T_pad = self._source_chunks(src_mel, bucket_lengths and use_scan)
        B = src_mel.shape[0]
        chunks, noise_chunks = self.scan_inputs(
            mel_ext, self._f0_noise(B, T_pad, generator, f0_noise))
        loop = self.stream_scan if use_scan else self._eager_loop
        wavs, codes, _ = loop(self.init_state(B), chunks, style_ctx, noise_chunks)
        wav = wavs.transpose(0, 1).reshape(B, -1)
        codes = codes.transpose(0, 1).reshape(B, -1)
        wav_out = wav[:, :T * self.cfg.mel.hop].cpu().numpy()
        if collect_codes:
            return wav_out, codes[:, :T].cpu().numpy()
        return wav_out

    @torch.inference_mode()
    def infer_offline(self, src_wav, ref_wav, collect_codes: bool = False,
                      bucket_lengths: bool = False,
                      generator: torch.Generator | None = None, f0_noise=None):
        """Non-streaming composition of the three stages (the equivalence
        check for ``infer_once``, and offline conversion); ``bucket_lengths``
        pads the source to the ladder, never the reference. Returns as
        ``infer_once`` does."""
        src_mel = self.wav_to_mel(src_wav)
        ref_mel = self.wav_to_mel(ref_wav)
        mel_ext, T, T_pad = self._source_chunks(src_mel, bucket_lengths)
        noise = self._f0_noise(src_mel.shape[0], T_pad, generator, f0_noise)
        with precision_scope("exact", self.device):
            codes = torch.argmax(self.emformer.apply(self.p_emformer, mel_ext), dim=-1)
        style_ctx = self._prepare(ref_mel)
        with precision_scope(self.serving_precision, self.device):
            ret = self.conan.decode(self.p_conan, codes, style_ctx, initial_noise=noise)
            wav = self.vocoder.apply(self.p_vocoder, ret["mel_out"])
        wav_out = wav[:, :T * self.cfg.mel.hop, 0].float().cpu().numpy()
        if collect_codes:
            return wav_out, codes[:, :T].cpu().numpy()
        return wav_out


def _copy_tree(dst, src) -> None:
    """Copy every leaf of ``src`` into the leaf of ``dst`` at the same key
    path (the trees' key sets must agree; their orders need not)."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"state keys differ: {sorted(set(dst) ^ set(src))}")
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s_ in zip(dst, src, strict=True):
            _copy_tree(d, s_)
    else:
        dst.copy_(src)


class CapturedChunkStep:
    """The engine's chunk step captured once into a CUDA graph.

    Static buffers hold the inputs (the mel chunk, the flow noise chunk,
    each leaf of the style context) and the state; inside the captured
    region the new state is copied into the state buffers, so one replay is
    one whole step. Before capture the step runs on a side stream (the
    warm-up PyTorch's CUDA-graph docs ask for; it also lets a cuDNN
    benchmark search, if one is on, run outside the capture). What the step
    reads is baked in at capture: the rung's TF32 flags and autocast are set
    inside the step itself. Autocast caches casts only of tensors that
    require grad, and the engine's weights do not, so its cache plays no
    part. Each buffer keeps the dtype it had at capture (a carry that the
    "fast" rung computes in bf16 is stored exactly in its fp32 buffer)."""

    WARMUP = 2

    def __init__(self, step_fn, state: dict, mel_chunk: torch.Tensor, style_ctx: dict,
                 f0_noise: torch.Tensor):
        self.state = tree_map(torch.clone, state)
        self.mel = mel_chunk.clone()
        self.noise = f0_noise.clone()
        self.style = tree_map(torch.clone, style_ctx)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                step_fn(self.state, self.mel, self.style, self.noise)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.wav, self.codes, new_state = step_fn(self.state, self.mel, self.style,
                                                      self.noise)
            _copy_tree(self.state, new_state)

    def run(self, state: dict, mel_chunks: torch.Tensor, style_ctx: dict,
            noise_chunks: torch.Tensor):
        """Replay once per chunk from ``state``; outputs are gathered into
        tensors on the device, with no host sync in the loop."""
        N = mel_chunks.shape[0]
        _copy_tree(self.state, state)
        _copy_tree(self.style, style_ctx)
        wavs = self.wav.new_empty((N, *self.wav.shape))
        codes = self.codes.new_empty((N, *self.codes.shape))
        for i in range(N):
            self.mel.copy_(mel_chunks[i])
            self.noise.copy_(noise_chunks[i])
            self.graph.replay()
            wavs[i].copy_(self.wav)
            codes[i].copy_(self.codes)
        return wavs, codes, tree_map(torch.clone, self.state)
