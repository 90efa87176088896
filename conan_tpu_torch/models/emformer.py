"""Emformer content extractor (``conan_tpu/models/emformer.py``).

Chunked streaming transformer, torchaudio's EmformerLayer semantics with no
memory bank, dropout 0, relu FFN, plus the Linear(80→100) code head:

    x   = [rc ∥ utt];  xn = LN_in(x)
    att = softmax(q kᵀ / sqrt(Dh) + mask) v → Wout  (q, k, v over [rc ∥ utt])
    y   = att + x;  y = FFN_preLN(y) + y;  out = LN_out(y)

Segment s queries attend to utterance[s·seg−L .. (s+1)·seg) ∥ rc block s.

The offline forward is the dense masked attention over [hard-copied
right-context blocks ∥ utterance] (the JAX package's oracle path,
``_offline_mask``/``_attention``, ``banded=False``); its banded TPU layout
is left out. It is also the training forward: the mask is built on the
device once per length and cached, and its additive -1e8 gives the softmax
an exact zero gradient at every masked key. The
streaming ``step`` carries a left-context K/V cache of L frames per layer and
a count of valid cache slots. Head dim is 10, so attention is a plain fp32
matmul and softmax; the engine runs this model in fp32 on every rung.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from conan_tpu_torch.nn import inits
from conan_tpu_torch.nn.blocks import init_layer_norm, layer_norm, linear
from conan_tpu_torch.nn.module import Params, State
from conan_tpu_torch.ops.precision import dot_at_rung

NEG_INF = -1e8


@dataclasses.dataclass(frozen=True)
class EmformerConfig:
    input_dim: int = 80
    num_heads: int = 8
    ffn_dim: int = 2048
    num_layers: int = 6
    segment_length: int = 4
    left_context_length: int = 50
    right_context_length: int = 2
    output_dim: int = 100  # distillation head (HuBERT codebook size)

    @classmethod
    def from_hparams(cls, hp) -> "EmformerConfig":
        return cls(
            input_dim=hp.get("emformer_input_dim", 80),
            num_layers=hp["emformer_layers"],
            segment_length=hp["chunk_size"] // 20,
            right_context_length=hp["right_context"],
            output_dim=hp.get("emformer_output_dim", 100),
        )

    @property
    def head_dim(self) -> int:
        return self.input_dim // self.num_heads


@functools.lru_cache(maxsize=16)
def _offline_mask(seg: int, rc: int, L: int, n_segs: int, device: torch.device) -> torch.Tensor:
    T, nrc = n_segs * seg, n_segs * rc
    i_rc = torch.arange(nrc, device=device)
    i_utt = torch.arange(T, device=device)
    q_seg = torch.cat([i_rc // max(rc, 1), i_utt // seg])          # each row's segment
    k_is_rc = torch.cat([torch.ones(nrc, dtype=torch.bool, device=device),
                         torch.zeros(T, dtype=torch.bool, device=device)])
    k_pos = torch.cat([torch.zeros(nrc, dtype=torch.long, device=device), i_utt])
    qs = q_seg[:, None]
    allowed_rc = k_is_rc[None, :] & (q_seg[None, :] == qs)
    allowed_utt = (~k_is_rc[None, :]) & (k_pos[None, :] >= qs * seg - L) \
        & (k_pos[None, :] < (qs + 1) * seg)
    zero = torch.zeros((), device=device)
    return torch.where(allowed_rc | allowed_utt, zero, torch.full((), NEG_INF, device=device))


class Emformer:
    def __init__(self, cfg: EmformerConfig):
        self.cfg = cfg

    # ----------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Params:
        D, F_ = self.cfg.input_dim, self.cfg.ffn_dim

        def lin(o, i, g=1.0):
            return {"w": inits.xavier_uniform(gen, (o, i), gain=g), "b": torch.zeros(o)}

        layers = []
        for i in range(self.cfg.num_layers):
            gain = 1.0 / math.sqrt(i + 1)
            layers.append({"q": lin(D, D, gain), "kv": lin(2 * D, D, gain),
                           "out": lin(D, D, gain), "ln_in": init_layer_norm(D),
                           "ln_out": init_layer_norm(D), "ffn_ln": init_layer_norm(D),
                           "ffn1": lin(F_, D), "ffn2": lin(D, F_)})
        return {"layers": layers}

    # ----------------------------------------------------------- offline
    def offline_mask(self, n_segs: int, device: torch.device | str) -> torch.Tensor:
        """[n_q, n_k] additive fp32 mask (0 allowed, NEG_INF not); rows and
        columns ordered [rc blocks (n_segs·rc) ∥ utterance (n_segs·seg)].
        Built on ``device`` from index comparisons and cached per
        (geometry, n_segs, device): at 3000 frames it is 4500² fp32, 81 MB."""
        cfg = self.cfg
        return _offline_mask(cfg.segment_length, cfg.right_context_length,
                             cfg.left_context_length, n_segs, torch.device(device))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.cfg.num_heads, self.cfg.head_dim)

    def _attend(self, p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        """q [B,Tq,D], k/v [B,Tk,D], bias additive, broadcastable to
        [B,H,Tq,Tk] → Wout(softmax(q kᵀ/√Dh + bias) v)."""
        B, Tq, D = q.shape
        logits = dot_at_rung(functools.partial(torch.einsum, "bqhd,bkhd->bhqk"),
                             self._heads(q), self._heads(k))
        probs = torch.softmax(logits * (self.cfg.head_dim ** -0.5) + bias, dim=-1)
        o = dot_at_rung(functools.partial(torch.einsum, "bhqk,bkhd->bqhd"), probs,
                        self._heads(v)).reshape(B, Tq, D)
        return linear(o, p["out"])

    def _ffn_out(self, p: Params, att: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        y = att + x
        h = torch.relu(linear(layer_norm(y, p["ffn_ln"]), p["ffn1"]))
        return layer_norm(y + linear(h, p["ffn2"]), p["ln_out"])

    def apply(self, params: Params, mel: torch.Tensor,
              lengths: torch.Tensor | None = None) -> torch.Tensor:
        """Offline forward. mel [B, T_in, D] with T_in = n_segs·seg + rc (the
        right-context lookahead included) → [B, T_utt, D]. ``lengths`` [B]
        counts the valid frames of ``mel``: every right-context key stays
        valid and utterance key j is valid iff j < lengths + T_utt − max(lengths)
        (torchaudio's padding mask)."""
        cfg = self.cfg
        seg, rc, D = cfg.segment_length, cfg.right_context_length, cfg.input_dim
        B, T_in, _ = mel.shape
        T = T_in - rc
        if T % seg:
            raise ValueError(f"utterance length {T} must be a multiple of segment {seg}")
        n_segs = T // seg
        nrc = n_segs * rc
        x = mel[:, :T]
        if rc > 0:
            # hard-copied right-context blocks: block s = input[(s+1)·seg : +rc]
            idx = ((torch.arange(n_segs, device=mel.device)[:, None] + 1) * seg
                   + torch.arange(rc, device=mel.device)[None, :])
            x = torch.cat([mel[:, idx.reshape(-1)], x], 1)
        bias = self.offline_mask(n_segs, mel.device)
        if lengths is not None:
            utt_hi = lengths + (T - torch.max(lengths))
            key_valid = torch.arange(T, device=mel.device)[None, :] < utt_hi[:, None]
            key_valid = torch.cat([torch.ones(B, nrc, dtype=torch.bool, device=mel.device),
                                   key_valid], 1)
            bias = bias[None] + torch.where(key_valid, 0.0, NEG_INF)[:, None, :]
            bias = bias[:, None]                                 # [B, 1, Tq, Tk]
        for lp in params["layers"]:
            xn = layer_norm(x, lp["ln_in"])
            kv = linear(xn, lp["kv"])
            att = self._attend(lp, linear(xn, lp["q"]), kv[..., :D], kv[..., D:], bias)
            x = self._ffn_out(lp, att, x)
        return x[:, nrc:]

    # ----------------------------------------------------------- streaming
    def init_state(self, batch: int, device: torch.device | str = "cpu") -> State:
        L, D = self.cfg.left_context_length, self.cfg.input_dim
        st: State = {"cache_len": torch.zeros((), dtype=torch.int32, device=device)}
        for i in range(self.cfg.num_layers):
            st[f"l{i}.k"] = torch.zeros(batch, L, D, device=device)
            st[f"l{i}.v"] = torch.zeros(batch, L, D, device=device)
        return st

    def step(self, params: Params, state: State, chunk: torch.Tensor):
        """One streaming step. chunk [B, seg+rc, D] (segment, then lookahead)
        → ([B, seg, D], state'). Equals the matching slice of ``apply``."""
        cfg = self.cfg
        seg, rc, L, D = (cfg.segment_length, cfg.right_context_length,
                         cfg.left_context_length, cfg.input_dim)
        x = torch.cat([chunk[:, seg:], chunk[:, :seg]], dim=1)   # [B, rc+seg, D]
        cache_len = state["cache_len"]
        # cache slot j (0..L-1) is valid iff j >= L - cache_len
        slots = torch.arange(L + rc + seg, device=chunk.device)
        bias = torch.where((slots >= L) | (slots >= L - cache_len), 0.0, NEG_INF)
        new_state: State = {"cache_len": torch.clamp(cache_len + seg, max=L)}
        for i, lp in enumerate(params["layers"]):
            xn = layer_norm(x, lp["ln_in"])
            kv_new = linear(xn, lp["kv"])
            k_cache, v_cache = state[f"l{i}.k"], state[f"l{i}.v"]
            k_new, v_new = kv_new[..., :D], kv_new[..., D:]
            att = self._attend(lp, linear(xn, lp["q"]), torch.cat([k_cache, k_new], 1),
                               torch.cat([v_cache, v_new], 1), bias)
            x = self._ffn_out(lp, att, x)
            # cache the segment rows' K/V (rows rc..rc+seg of the new ones)
            new_state[f"l{i}.k"] = torch.cat([k_cache, k_new[:, rc:]], 1)[:, -L:]
            new_state[f"l{i}.v"] = torch.cat([v_cache, v_new[:, rc:]], 1)[:, -L:]
        return x[:, rc:], new_state


class EmformerDistillModel:
    """Emformer + Linear code head."""

    def __init__(self, cfg: EmformerConfig):
        self.cfg = cfg
        self.emformer = Emformer(cfg)

    def init(self, gen: torch.Generator) -> Params:
        D, O = self.cfg.input_dim, self.cfg.output_dim
        p = self.emformer.init(gen)
        p["proj"] = {"w": inits.kaiming_uniform(gen, (O, D)),
                     "b": inits.default_bias(gen, (O,), (O, D))}
        return p

    def apply(self, params: Params, mel: torch.Tensor,
              lengths: torch.Tensor | None = None) -> torch.Tensor:
        """[B, T_in, 80] → logits [B, T_utt, output_dim]."""
        return linear(self.emformer.apply(params, mel, lengths), params["proj"])

    def init_state(self, batch: int, device: torch.device | str = "cpu") -> State:
        return self.emformer.init_state(batch, device)

    def step(self, params: Params, state: State, chunk: torch.Tensor):
        h, state = self.emformer.step(params, state, chunk)
        return linear(h, params["proj"]), state
