"""Adaptive style encoder (``conan_tpu/models/conan/prosody.py``).

  VQEmbeddingEMA     nearest-codeword quantization of the prosody; in
                     training the EMA codebook update, the commitment loss and
                     the perplexity (``forward``), and the one-time k-means
                     bootstrap on the host (``kmeans_init_host``)
  ProsodyAligner     cross-attention of content queries over prosody; in
                     training the hard banded-diagonal forcing, selected by a
                     device bool, and the guided-attention loss
  LocalStyleAdaptor  WaveNet over the reference mel → group frames by 4
                     → ConvBlocks → VQ, gated by ``use_vq`` in training

The codebook state is a tree ``{"embedding", "ema_count", "ema_weight",
"initialized"}`` that the train step carries; one GPU, so no statistics are
summed across replicas.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from conan_tpu_torch.nn.blocks import (ConvBlocks, MultiheadAttention, WaveNet, dropout,
                                       init_layer_norm, init_linear, layer_norm, linear)
from conan_tpu_torch.nn import inits
from conan_tpu_torch.nn.module import Params
from conan_tpu_torch.ops.precision import dot_at_rung


@dataclasses.dataclass(frozen=True)
class VQConfig:
    n_embeddings: int = 512
    dim: int = 256
    commitment_cost: float = 0.25


class VQEmbeddingEMA:
    DECAY, EPSILON = 0.999, 1e-5     # the EMA's decay, the Laplace smoothing

    def __init__(self, cfg: VQConfig):
        self.cfg = cfg

    def init_state(self, gen: torch.Generator) -> Params:
        emb = inits.uniform(gen, (self.cfg.n_embeddings, self.cfg.dim), -1 / 512, 1 / 512)
        return {"embedding": emb, "ema_count": torch.zeros(self.cfg.n_embeddings),
                "ema_weight": emb.clone(), "initialized": torch.zeros(())}

    def encode(self, state: Params, x: torch.Tensor):
        """x: [B, T, D] → (quantized [B, T, D], indices [B, T])."""
        emb = state["embedding"]
        d = (torch.sum(emb ** 2, 1)[None, None, :]
             + torch.sum(x ** 2, -1, keepdim=True)
             - 2.0 * dot_at_rung(functools.partial(torch.einsum, "btd,nd->btn"), x, emb))
        idx = torch.argmin(d, dim=-1)
        return F.embedding(idx, emb), idx

    def kmeans_init_host(self, state: Params, x_flat: np.ndarray, seed: int = 0) -> Params:
        """The data-dependent init on the host: scipy's kmeans2 over the rows
        of ``x_flat`` [N, dim] (shuffled by a seeded permutation, float64,
        ``minit="points"``), then the EMA buffers bootstrapped from the hard
        assignments. Returns a new state on the device of ``state``."""
        from scipy.cluster.vq import kmeans2

        rng = np.random.default_rng(seed)
        x = np.asarray(x_flat, np.float64)
        x = x[rng.permutation(len(x))]
        centers, _ = kmeans2(x, self.cfg.n_embeddings, minit="points", seed=seed)
        d = (np.sum(centers ** 2, 1)[None, :] + np.sum(x ** 2, 1)[:, None]
             - 2.0 * x @ centers.T)
        onehot = np.eye(self.cfg.n_embeddings)[d.argmin(1)]
        like = state["embedding"]

        def to(a):
            return torch.from_numpy(a.astype(np.float32)).to(like.device, like.dtype)

        return {"embedding": to(centers), "ema_count": to(onehot.sum(0)),
                "ema_weight": to(onehot.T @ x),
                "initialized": torch.ones_like(state["initialized"])}

    def forward(self, state: Params, x: torch.Tensor):
        """The training forward. x: [B, T, D] → (straight-through quantized
        [B, T, D], commitment loss, indices [B, T], perplexity, new state).
        The EMA counts and weights move (with Laplace smoothing) and the
        codebook is their ratio, applied only once ``initialized`` is set;
        the new state then has ``initialized`` 1. All on the device."""
        cfg, decay, eps = self.cfg, self.DECAY, self.EPSILON
        q, idx = self.encode(state, x)
        onehot = F.one_hot(idx.reshape(-1), cfg.n_embeddings).to(x.dtype)   # [BT, M]
        counts = onehot.sum(0)
        dw = onehot.T @ x.detach().reshape(-1, x.shape[-1])
        ema_count = decay * state["ema_count"] + (1 - decay) * counts
        n = ema_count.sum()
        ema_count = (ema_count + eps) / (n + cfg.n_embeddings * eps) * n
        ema_weight = decay * state["ema_weight"] + (1 - decay) * dw
        init = state["initialized"] > 0
        new_state = {"embedding": torch.where(init, ema_weight / ema_count[:, None],
                                              state["embedding"]),
                     "ema_count": torch.where(init, ema_count, state["ema_count"]),
                     "ema_weight": torch.where(init, ema_weight, state["ema_weight"]),
                     "initialized": torch.ones_like(state["initialized"])}
        # the commitment loss over the nonzero (unpadded) frames
        nonpad = (x.abs().sum(-1) > 0).to(x.dtype)
        e_latent = torch.mean(torch.square(x - q.detach()), dim=-1)
        loss = cfg.commitment_cost * (e_latent * nonpad).sum() / nonpad.sum().clamp(min=1.0)
        avg_probs = counts / max(idx.numel(), 1)
        ppl = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        return x + (q - x).detach(), loss, idx, ppl, new_state


def guided_attention_mask(ilen: int, rilen: torch.Tensor, olen: int, rolen: torch.Tensor,
                          sigma: float = 0.3) -> torch.Tensor:
    """1 - exp(-(y/olen - x/ilen)² / (2σ²)) of the valid lengths ``rilen``,
    ``rolen`` [B] → [B, ilen, olen]."""
    gx = torch.arange(ilen, device=rilen.device)[None, :, None]
    gy = torch.arange(olen, device=rilen.device)[None, None, :]
    return 1.0 - torch.exp(-torch.square(gy / rolen[:, None, None] - gx / rilen[:, None, None])
                           / (2 * sigma ** 2))


class ProsodyAligner:
    """N× cross-attention (content queries × prosody keys) + FFN, post-LN."""

    P, SIGMA = 0.1, 0.3     # dropout rate, the guided-attention mask's width

    def __init__(self, num_layers: int = 2, hidden: int = 256, nhead: int = 2,
                 ffn_dim: int = 2048):
        self.n = num_layers
        self.hidden = hidden
        self.mha = MultiheadAttention(hidden, nhead)
        self.ffn_dim = ffn_dim

    def init(self, gen: torch.Generator) -> Params:
        return {"layers": [{"attn": self.mha.init(gen),
                            "lin1": init_linear(gen, self.ffn_dim, self.hidden),
                            "lin2": init_linear(gen, self.hidden, self.ffn_dim),
                            "norm1": init_layer_norm(self.hidden),
                            "norm2": init_layer_norm(self.hidden)}
                           for _ in range(self.n)]}

    def apply(self, params: Params, src: torch.Tensor, prosody: torch.Tensor,
              pros_key_padding_mask: torch.Tensor | None) -> torch.Tensor:
        """src: [B, Tq, H] content; prosody: [B, Tk, H] → [B, Tq, H]. Every
        query row is computed on its own, so a chunk of queries gives the
        matching rows of the whole."""
        return self._layers(params, src, prosody, pros_key_padding_mask)[0]

    def _layers(self, params: Params, src: torch.Tensor, prosody: torch.Tensor,
                pros_key_padding_mask: torch.Tensor | None, forcing=None,
                generator: torch.Generator | None = None):
        """The post-LN layers → (output, per-layer attention). With
        ``forcing`` = (device bool, banded attention [B, Tq, Tk], its output
        [B, Tq, H]), each layer takes the forced attention while the bool
        holds, and the attention is returned."""
        out, attn_list = src, []
        for lp in params["layers"]:
            if forcing is None:
                attn_out = self.mha.apply(lp["attn"], out, prosody, prosody,
                                          pros_key_padding_mask, generator=generator)
            else:
                on, forced_attn, forced_out = forcing
                attn_out, soft_attn = self.mha.apply(lp["attn"], out, prosody, prosody,
                                                     pros_key_padding_mask, generator=generator,
                                                     need_weights=True)
                attn_out = torch.where(on, forced_out, attn_out)
                attn_list.append(torch.where(on, forced_attn, soft_attn))
            out = layer_norm(out + dropout(attn_out, self.P, generator), lp["norm1"])
            h = linear(F.relu(linear(out, lp["lin1"])), lp["lin2"])
            out = layer_norm(out + dropout(h, self.P, generator), lp["norm2"])
        return out, attn_list

    def _forcing_attn(self, Tq: int, Tk: int, like: torch.Tensor) -> torch.Tensor:
        """The hard banded diagonal [Tq, Tk]: query i attends to the keys
        from floor(i·Tk/Tq) - 1 up to ceil(i·Tk/Tq), in float32 as JAX."""
        i = torch.arange(Tq, dtype=torch.float32, device=like.device) * (Tk / Tq)
        cols = torch.arange(Tk, dtype=torch.float32, device=like.device)[None, :]
        band = ((cols < (torch.ceil(i) + 1)[:, None]).float()
                - (cols < (torch.floor(i) - 1)[:, None]).float())
        return band.to(like.dtype)

    def apply_train(self, params: Params, src: torch.Tensor, prosody: torch.Tensor,
                    src_key_padding_mask: torch.Tensor, pros_key_padding_mask: torch.Tensor,
                    *, forcing: torch.Tensor | bool,
                    generator: torch.Generator | None = None):
        """The training forward: src [B, Tq, H], prosody [B, Tk, H] →
        (output [B, Tq, H], guided-attention loss summed over the layers,
        per-layer attention [B, Tq, Tk]). While ``forcing`` (a device bool)
        holds, each layer attends along the hard banded diagonal instead of
        its own attention; both are computed and one is selected, so one
        step serves both phases. With a ``generator``, dropout on the
        attention probabilities and on both residual branches."""
        B, Tq, _ = src.shape
        Tk = prosody.shape[1]
        forced_attn = self._forcing_attn(Tq, Tk, src)[None].expand(B, Tq, Tk)
        forcing = (torch.as_tensor(forcing, device=src.device), forced_attn,
                   dot_at_rung(functools.partial(torch.einsum, "bqk,bkh->bqh"), forced_attn,
                               prosody))
        out, attn_list = self._layers(params, src, prosody, pros_key_padding_mask, forcing,
                                      generator)
        s_len = torch.sum(1.0 - src_key_padding_mask.to(src.dtype), -1)
        e_len = torch.sum(1.0 - pros_key_padding_mask.to(src.dtype), -1)
        w = guided_attention_mask(Tq, s_len, Tk, e_len, self.SIGMA)
        nonpad = (~src_key_padding_mask)[:, :, None] & (~pros_key_padding_mask)[:, None, :]
        guided_loss = sum(torch.sum(attn * w * nonpad) / nonpad.sum().clamp(min=1)
                          for attn in attn_list)
        return out, guided_loss, attn_list


def group_by_segments(h: torch.Tensor, group: int) -> torch.Tensor:
    """Mean over consecutive groups of ``group`` frames; the ragged last group
    averages over its actual count."""
    B, T, D = h.shape
    n_groups = -(-T // group)
    pad = n_groups * group - T
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    sums = h.reshape(B, n_groups, group, D).sum(dim=2)
    counts = torch.full((n_groups,), float(group), device=h.device)
    if pad:
        counts[-1] = group - pad
    return sums / counts[None, :, None]


class LocalStyleAdaptor:
    def __init__(self, hidden: int = 256, n_vq: int = 512, vae_dropout: float = 0.0,
                 lambda_commit: float = 0.25):
        self.hidden = hidden
        self.wavenet = WaveNet(80, kernel_size=3, dilation_rate=1, n_layers=4)
        self.encoder = ConvBlocks(80, hidden, [1] * 5, 5, dropout=vae_dropout)
        self.vq = VQEmbeddingEMA(VQConfig(n_vq, hidden, commitment_cost=lambda_commit))

    def init(self, gen: torch.Generator) -> Params:
        return {"wavenet": self.wavenet.init(gen), "encoder": self.encoder.init(gen)}

    def pre_vq(self, params: Params, ref_mels: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """ref mel [B, T, 80] → prosody features [B, ceil(T/4), hidden] (no
        VQ). A frame is padding where its first mel bin is exactly 0."""
        nonpad = (ref_mels[:, :, :1] != 0.0).to(ref_mels.dtype)   # padding_idx=0
        h = self.wavenet.apply(params["wavenet"], ref_mels, nonpad)
        h = group_by_segments(h, 4)
        return self.encoder.apply(params["encoder"], h, generator=generator)

    def apply_train(self, params: Params, vq_state: Params, ref_mels: torch.Tensor, *,
                    use_vq: torch.Tensor | bool, generator: torch.Generator | None = None):
        """The training forward → (prosody [B, ceil(T/4), H], VQ loss,
        perplexity, new VQ state). While ``use_vq`` (a device bool) is false,
        the prosody passes unquantized, the loss is 0 and the state stays as
        it was."""
        prosody = self.pre_vq(params, ref_mels, generator)
        q, vq_loss, _idx, ppl, new_state = self.vq.forward(vq_state, prosody)
        use = torch.as_tensor(use_vq, device=prosody.device)
        return (torch.where(use, q, prosody), torch.where(use, vq_loss, 0.0), ppl,
                {k: torch.where(use, new_state[k], vq_state[k]) for k in vq_state})

    def apply(self, params: Params, vq_state: Params, ref_mels: torch.Tensor) -> torch.Tensor:
        """Quantized prosody [B, ceil(T/4), H]. Written x + (q - x) as the
        straight-through form of the JAX package, so the rounding is the same."""
        x = self.pre_vq(params, ref_mels)
        q, _idx = self.vq.encode(vq_state, x)
        return x + (q - x)
