"""The original system's PyTorch state dicts ↔ the port's parameter trees
(``conan_tpu/utils/torch_compat.py``).

Each ``*_names`` function gives a module's name tree: its parameter tree with
the reference state-dict key at each leaf (``checkpoint.py``). The
``*_from_torch`` functions read a state dict of tensors or numpy arrays
through it onto a device (None: the card); ``emformer_to_torchaudio`` and
``conan_to_torch`` write a tree back under the reference's keys. Keys the
port does not use are ignored.
"""

from __future__ import annotations

import torch

from conan_tpu_torch.checkpoint import params_from_state_dict, state_dict_from_params
from conan_tpu_torch.models.conan.flow import DiffNet, DiffNetConfig


def _lin(p: str) -> dict:
    return {"w": f"{p}.weight", "b": f"{p}.bias"}


def _ln(p: str) -> dict:
    return {"scale": f"{p}.weight", "bias": f"{p}.bias"}


def _wn(p: str) -> dict:
    return {"v": f"{p}.weight_v", "g": f"{p}.weight_g", "b": f"{p}.bias"}


def conv_blocks_names(prefix: str, n_blocks: int, n_sub: int, causal: bool) -> dict:
    """Reference ConvBlocks / CausalConvBlocks (conv.py:84-264). Sequential
    indices: non-causal blocks.{j} = [norm, conv, λ, act, conv1x1] → (0, 1,
    4); causal = [norm, λpad, conv, λ, act, conv1x1] → (0, 2, 5). The post
    net is a bare conv (non-causal) or Sequential(λpad, conv) (causal)."""
    i_norm, i_c1, i_c2 = (0, 2, 5) if causal else (0, 1, 4)
    base = f"{prefix}.res_blocks.{{}}.blocks.{{}}"
    return {"blocks": [[{"norm": _ln(f"{base.format(i, j)}.{i_norm}"),
                         "conv1": _lin(f"{base.format(i, j)}.{i_c1}"),
                         "conv2": _lin(f"{base.format(i, j)}.{i_c2}")}
                        for j in range(n_sub)] for i in range(n_blocks)],
            "last_norm": _ln(f"{prefix}.last_norm"),
            "post": _lin(f"{prefix}.post_net1.1" if causal else f"{prefix}.post_net1")}


def wavenet_names(prefix: str, n_layers: int, causal: bool, cond: bool) -> dict:
    """WN / CausalWN (wavenet.py): weight-normed in and res_skip layers."""
    p = {"in": [_wn(f"{prefix}.in_layers.{i}" + (".conv" if causal else ""))
                for i in range(n_layers)],
         "res_skip": [_wn(f"{prefix}.res_skip_layers.{i}") for i in range(n_layers)]}
    if cond:
        p["cond"] = _wn(f"{prefix}.cond_layer")
    return p


def pitch_predictor_names(prefix: str, n_layers: int = 5) -> dict:
    return {"convs": [_lin(f"{prefix}.conv.{i}.0.conv") for i in range(n_layers)],
            "ln": _ln(f"{prefix}.post_ln"), "out": _lin(f"{prefix}.linear")}


def mha_names(prefix: str) -> dict:
    return {"in_w": f"{prefix}.in_proj_weight", "in_b": f"{prefix}.in_proj_bias",
            "out": _lin(f"{prefix}.out_proj")}


def aligner_names(prefix: str, n_layers: int = 2) -> dict:
    return {"layers": [{"attn": mha_names(f"{prefix}.layers.{i}.multihead_attn"),
                        "lin1": _lin(f"{prefix}.layers.{i}.linear1"),
                        "lin2": _lin(f"{prefix}.layers.{i}.linear2"),
                        "norm1": _ln(f"{prefix}.layers.{i}.norm1"),
                        "norm2": _ln(f"{prefix}.layers.{i}.norm2")}
                       for i in range(n_layers)]}


def vq_state_names(prefix: str) -> dict:
    return {"embedding": f"{prefix}.embedding", "ema_count": f"{prefix}.ema_count",
            "ema_weight": f"{prefix}.ema_weight", "initialized": f"{prefix}.data_initialized"}


def emformer_names(num_layers: int, heads: tuple[str, ...]) -> dict:
    """torchaudio's Emformer under ``emformer.`` (memory bank off: no summary
    or memory paths) and the code heads ``heads`` ("proj", or "proj1" and
    "proj2")."""
    def layer(i):
        b = f"emformer.emformer_layers.{i}"
        return {"q": _lin(f"{b}.attention.emb_to_query"),
                "kv": _lin(f"{b}.attention.emb_to_key_value"),
                "out": _lin(f"{b}.attention.out_proj"),
                "ln_in": _ln(f"{b}.layer_norm_input"), "ln_out": _ln(f"{b}.layer_norm_output"),
                "ffn_ln": _ln(f"{b}.pos_ff.0"), "ffn1": _lin(f"{b}.pos_ff.1"),
                "ffn2": _lin(f"{b}.pos_ff.4")}

    return {"layers": [layer(i) for i in range(num_layers)], **{h: _lin(h) for h in heads}}


def conan_names(cfg, spk_id: bool) -> dict:
    """The reference Conan (modules/Conan/Conan.py:45-113) without its VQ
    state and flow F0 net, which map on their own."""
    p = {"content_embedding": {"w": "content_embedding.weight"},
         "content_proj": _lin("content_proj.0.conv"),
         "global_conv_in": _lin("global_conv_in"),
         "global_encoder": conv_blocks_names("global_encoder", 5, 2, causal=False),
         "uv_predictor": pitch_predictor_names("uv_predictor"),
         "pitch_embed": {"w": "pitch_embed.weight"},
         "decoder": conv_blocks_names("decoder", len(cfg.dec_dilations), cfg.layers_in_block,
                                      causal=True),
         "mel_out": _lin("mel_out")}
    if spk_id:      # the use_spk_id path (fs.py:59-60)
        p["spk_id_proj"] = {"w": "spk_id_proj.weight"}
    if cfg.style:
        p["prosody"] = {
            "wavenet": wavenet_names("prosody_extractor.wavenet", 4, causal=False, cond=False),
            "encoder": conv_blocks_names("prosody_extractor.encoder", 5, 2, causal=False)}
        p["l1"] = _lin("l1")
        p["aligner"] = aligner_names("align")
    return p


# ---------------------------------------------------------------------------
# state dict → tree (the JAX package's functions, with a device)
# ---------------------------------------------------------------------------

def conv_blocks_from_torch(sd, prefix: str, n_blocks: int, n_sub: int, causal: bool,
                           device=None) -> dict:
    return params_from_state_dict(sd, conv_blocks_names(prefix, n_blocks, n_sub, causal),
                                  device)


def wavenet_from_torch(sd, prefix: str, n_layers: int, causal: bool, device=None) -> dict:
    cond = f"{prefix}.cond_layer.weight_v" in sd
    return params_from_state_dict(sd, wavenet_names(prefix, n_layers, causal, cond), device)


def pitch_predictor_from_torch(sd, prefix: str, n_layers: int = 5, device=None) -> dict:
    return params_from_state_dict(sd, pitch_predictor_names(prefix, n_layers), device)


def mha_from_torch(sd, prefix: str, device=None) -> dict:
    return params_from_state_dict(sd, mha_names(prefix), device)


def aligner_from_torch(sd, prefix: str, n_layers: int = 2, device=None) -> dict:
    return params_from_state_dict(sd, aligner_names(prefix, n_layers), device)


def vq_state_from_torch(sd, prefix: str, device=None) -> dict:
    """The EMA VQ's buffers; its ``data_initialized`` flag becomes a scalar."""
    st = params_from_state_dict(sd, vq_state_names(prefix), device)
    st["initialized"] = st["initialized"].reshape(())
    return st


def emformer_from_torchaudio(sd, num_layers: int, device=None) -> dict:
    """A trained reference Emformer (torchaudio ``Emformer`` under
    ``emformer.`` plus the code head: reference
    `modules/Emformer/emformer.py:14-30`) → ``EmformerDistillModel``'s tree.
    The attention is the same function (queries over [rc ∥ utt], keys the
    same set, scaling head_dim^-0.5, pre-LN FFN, output LN)."""
    heads = tuple(h for h in ("proj", "proj1", "proj2") if f"{h}.weight" in sd)
    return params_from_state_dict(sd, emformer_names(num_layers, heads), device)


def conan_from_torch(sd, cfg, device=None) -> tuple[dict, dict | None]:
    """A reference Conan state dict → (params, vq_state); vq_state is None
    without ``cfg.style``."""
    params = params_from_state_dict(sd, conan_names(cfg, "spk_id_proj.weight" in sd), device)
    vq_state = vq_state_from_torch(sd, "prosody_extractor.vqvae", device) if cfg.style else None
    if cfg.f0_gen == "flow":
        params["f0_net"] = DiffNet(DiffNetConfig()).params_from_torch(sd, "pitch_flownet.",
                                                                      device)
    return params, vq_state


# ---------------------------------------------------------------------------
# tree → state dict
# ---------------------------------------------------------------------------

def emformer_to_torchaudio(params: dict) -> dict[str, torch.Tensor]:
    """``EmformerDistillModel``'s tree under the reference's keys."""
    heads = tuple(h for h in ("proj", "proj1", "proj2") if h in params)
    return state_dict_from_params(params, emformer_names(len(params["layers"]), heads))


def conan_to_torch(params: dict, vq_state: dict | None, cfg) -> dict[str, torch.Tensor]:
    """Conan's params and VQ state under the reference's keys
    (``data_initialized`` as the reference's one-element buffer)."""
    core = {k: v for k, v in params.items() if k != "f0_net"}
    sd = state_dict_from_params(core, conan_names(cfg, "spk_id_proj" in params))
    if cfg.style:
        vq = state_dict_from_params(vq_state, vq_state_names("prosody_extractor.vqvae"))
        vq["prosody_extractor.vqvae.data_initialized"] = \
            vq["prosody_extractor.vqvae.data_initialized"].reshape(1)
        sd.update(vq)
    if cfg.f0_gen == "flow":
        sd.update(DiffNet(DiffNetConfig()).params_to_torch(params["f0_net"], "pitch_flownet."))
    return sd
