"""The import of the original system's PyTorch state dicts into the port
(``conan_tpu_torch/utils/torch_compat.py`` and the models' ``params_from_torch``)
against the JAX package's mappers (``conan_tpu/utils/torch_compat.py``), on
the CPU.

Each state dict is written by the port's inverse (``*_to_torch``) from a
tree made from ``jax.eval_shape`` of the JAX init with seeded numpy values.
JAX's own mapper must give that tree back exactly: that holds the inverse,
and the key names it writes, to the names JAX reads. The port's mapper must
then equal JAX's leaf by leaf, exactly, from tensors and from numpy arrays.
One forward per model through both packages on the mapped weights closes
each case (fp32 in other summation orders: atol 1e-4, as
tests/test_torch_modules.py; flow F0 1e-3, as tests/test_torch_flow.py).

Sizes: the SMALL engine's widths (hidden 64, Emformer 2 layers of FFN 64,
HiFi-GAN 32 channels), B = 2.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conan_tpu.models.conan.flow import DiffNet as JDiffNet
from conan_tpu.models.conan.flow import DiffNetConfig as JDiffNetConfig
from conan_tpu.models.conan.model import Conan as JConan
from conan_tpu.models.emformer import EmformerDistillModel as JEmformer
from conan_tpu.models.vocoder.hifigan import HifiGanGenerator as JHifiGan
from conan_tpu.models.vocoder.hifigan_noncausal import NonCausalHifiGanGenerator as JNonCausal
from conan_tpu.models.vocoder.hifigan_nsf import NsfHifiGanGenerator as JNsf
from conan_tpu.utils import torch_compat as jcompat

from conan_tpu_torch.checkpoint import (load_ckpt_state, params_from_jax, params_from_state_dict,
                                        save_checkpoint, state_dict_from_params)
from conan_tpu_torch.models.conan.flow import DiffNet, DiffNetConfig
from conan_tpu_torch.models.conan.model import Conan, ConanConfig
from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
from conan_tpu_torch.models.vocoder.hifigan_noncausal import NonCausalHifiGanGenerator
from conan_tpu_torch.models.vocoder.hifigan_nsf import NsfHifiGanGenerator
from conan_tpu_torch.utils import torch_compat

from tests.test_torch_flow import FLOW
from tests.test_torch_vocoder_families import JCFG, NSF_RATES, _nsf_params
from tests.torch_port_util import SMALL, leaf_paths, numpy_params
from tests.torch_port_util import one_torch_thread  # noqa: F401

B = 2


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _numpy_sd(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_tree(got, want):
    """The same key paths, and at each the same values, dtype and shape; an
    int leaf (the NSF's strides) the same int."""
    g = got if isinstance(got, dict) else {"": got}
    w = want if isinstance(want, dict) else {"": want}
    assert leaf_paths(g) == leaf_paths(w)
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, g, is_leaf=torch.is_tensor)),
            jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, w))):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _port_conan_cfg(jcfg):
    return ConanConfig(**dataclasses.asdict(jcfg))


def _conan_case(jcfg, seed):
    """(JAX model, port config, JAX tree, VQ state, exported state dict)."""
    jm = JConan(jcfg)
    p_np = numpy_params(jm.init, seed)
    vq_np = numpy_params(jm.init_vq_state, seed + 1)
    cfg = _port_conan_cfg(jcfg)
    sd = torch_compat.conan_to_torch(params_from_jax(p_np, "cpu"),
                                     params_from_jax(vq_np, "cpu"), cfg)
    return jm, cfg, p_np, vq_np, sd


CONAN_CASES = {"orig": SMALL.conan,
               "flow_spk_id": dataclasses.replace(FLOW.conan, use_spk_id=True, num_spk=7)}


@pytest.mark.parametrize("case", list(CONAN_CASES))
def test_conan_mapping_matches_jax(case):
    """The Conan (style, VQ state; the flow F0 net and the speaker-id
    embedding in the second case): JAX's mapper gives the tree back, the
    port's equals JAX's, and both infer the same mel (and flow F0)."""
    jcfg = CONAN_CASES[case]
    jm, cfg, p_np, vq_np, sd = _conan_case(jcfg, seed=31)
    assert "prosody_extractor.vqvae.data_initialized" in sd
    jp, jvq = jcompat.conan_from_torch(_numpy_sd(sd), jcfg)
    _assert_same_tree(jp, p_np)
    _assert_same_tree(jvq, vq_np)
    for source in (sd, _numpy_sd(sd)):
        pp, pvq = torch_compat.conan_from_torch(source, cfg, device="cpu")
        _assert_same_tree(pp, jp)
        _assert_same_tree(pvq, jvq)
    rng = np.random.default_rng(32)
    codes = rng.integers(0, 100, (B, 12)).astype(np.int32)
    codes[:, 3] = 57
    ref = rng.standard_normal((B, 30, 80)).astype(np.float32)
    kw = {}
    if jcfg.f0_gen == "flow":
        kw["initial_noise"] = np.asarray(jm.sample_f0_noise(jax.random.PRNGKey(5), B, 12))
    want = jax.jit(lambda p_, v_, c_, r_, kw_: jm.apply(p_, c_, ref=r_, vq_state=v_, infer=True,
                                                        **kw_))(jp, jvq, codes, ref, kw)
    got = Conan(cfg).apply(pp, _t(codes), ref=_t(ref), vq_state=pvq,
                           **{k: _t(v) for k, v in kw.items()})
    _close(got["mel_out"], want["mel_out"])
    _close(got["f0_denorm_pred"], want["f0_denorm_pred"], atol=1e-3)


# the sub-module mappers, each on the Conan state dict, port against JAX
SUB_MAPPERS = [
    ("conv_blocks_from_torch", ("global_encoder", 5, 2, False)),
    ("conv_blocks_from_torch", ("decoder", 4, 2, True)),
    ("conv_blocks_from_torch", ("prosody_extractor.encoder", 5, 2, False)),
    ("wavenet_from_torch", ("prosody_extractor.wavenet", 4, False)),
    ("pitch_predictor_from_torch", ("uv_predictor",)),
    ("mha_from_torch", ("align.layers.1.multihead_attn",)),
    ("aligner_from_torch", ("align",)),
    ("vq_state_from_torch", ("prosody_extractor.vqvae",)),
]


@pytest.fixture(scope="module")
def conan_sd():
    return _conan_case(SMALL.conan, seed=33)[4]


@pytest.mark.parametrize("name,args", SUB_MAPPERS, ids=[f"{n}-{a[0]}" for n, a in SUB_MAPPERS])
def test_submodule_mappers_match_jax(conan_sd, name, args):
    want = getattr(jcompat, name)(_numpy_sd(conan_sd), *args)
    _assert_same_tree(getattr(torch_compat, name)(conan_sd, *args, device="cpu"), want)


def test_wavenet_cond_layer_and_causal_names_match_jax(conan_sd):
    """The WN's optional cond layer and the causal WN's ``.conv`` names,
    which the Conan does not use: a state dict renamed to them."""
    sd = {k.replace("in_layers.0.", "in_layers.0.conv.").replace("in_layers.1.",
                                                                 "in_layers.1.conv."): v
          for k, v in conan_sd.items() if k.startswith("prosody_extractor.wavenet.")}
    sd.update({f"prosody_extractor.wavenet.cond_layer.{n}": torch.full((4, 2, 1), 0.5)
               for n in ("weight_v", "weight_g")})
    sd["prosody_extractor.wavenet.cond_layer.bias"] = torch.arange(4.0)
    want = jcompat.wavenet_from_torch(_numpy_sd(sd), "prosody_extractor.wavenet", 2,
                                      causal=True)
    got = torch_compat.wavenet_from_torch(sd, "prosody_extractor.wavenet", 2, causal=True,
                                          device="cpu")
    assert "cond" in got
    _assert_same_tree(got, want)


def test_emformer_mapping_matches_jax():
    """EmformerDistillModel: JAX's mapper gives the tree back from the
    torchaudio names, the port's equals it, both give the same logits; a
    state dict with the two-head (proj1, proj2) variant maps alike."""
    jm = JEmformer(SMALL.emformer)
    p_np = numpy_params(jm.init, seed=34)
    sd = torch_compat.emformer_to_torchaudio(params_from_jax(p_np, "cpu"))
    n = SMALL.emformer.num_layers
    jp = jcompat.emformer_from_torchaudio(_numpy_sd(sd), n)
    _assert_same_tree(jp, p_np)
    pp = torch_compat.emformer_from_torchaudio(sd, n, device="cpu")
    _assert_same_tree(pp, jp)
    mel = np.random.default_rng(35).standard_normal((B, 7 * 4 + 2, 80)).astype(np.float32)
    pm = EmformerDistillModel(EmformerConfig(**dataclasses.asdict(SMALL.emformer)))
    want = np.asarray(jax.jit(jm.apply)(jp, mel))
    got = pm.apply(pp, _t(mel))
    _close(got, want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    two = dict(sd)
    for h in ("proj1", "proj2"):
        two[f"{h}.weight"], two[f"{h}.bias"] = sd["proj.weight"] + 1, sd["proj.bias"] - 1
    _assert_same_tree(torch_compat.emformer_from_torchaudio(two, n, device="cpu"),
                      jcompat.emformer_from_torchaudio(_numpy_sd(two), n))


def test_emformer_two_heads_mapping_matches_jax():
    """``mode="both"``: the tree written by ``emformer_to_torchaudio`` and read
    back by both packages' ``emformer_from_torchaudio`` is the same tree, and
    the port runs it: (logits, features) equal JAX's at atol 1e-4."""
    jm = JEmformer(SMALL.emformer, mode="both")
    p_np = numpy_params(jm.init, seed=37)
    sd = torch_compat.emformer_to_torchaudio(params_from_jax(p_np, "cpu"))
    assert {"proj1.weight", "proj2.weight"} <= set(sd) and "proj.weight" not in sd
    n = SMALL.emformer.num_layers
    jp = jcompat.emformer_from_torchaudio(_numpy_sd(sd), n)
    _assert_same_tree(jp, p_np)
    pp = torch_compat.emformer_from_torchaudio(sd, n, device="cpu")
    _assert_same_tree(pp, jp)
    mel = np.random.default_rng(38).standard_normal((B, 7 * 4 + 2, 80)).astype(np.float32)
    pm = EmformerDistillModel(EmformerConfig(**dataclasses.asdict(SMALL.emformer)),
                              mode="both")
    want = jax.jit(jm.apply)(jp, mel)
    got = pm.apply(pp, _t(mel))
    for a, b in zip(got, want, strict=True):
        _close(a, b)


def _vocoder(kind, upsample="shuffle", resblock="1"):
    jcfg = dataclasses.replace(JCFG, upsample=upsample, resblock=resblock)
    if kind == "nsf":
        jcfg = dataclasses.replace(jcfg, **NSF_RATES)
    cfg = HifiGanConfig(**dataclasses.asdict(jcfg))
    jm, pm = {"causal": (JHifiGan, HifiGanGenerator),
              "noncausal": (JNonCausal, NonCausalHifiGanGenerator),
              "nsf": (JNsf, NsfHifiGanGenerator)}[kind]
    return jm(jcfg), pm(cfg)


VOCODERS = [("causal", "shuffle", "1"), ("causal", "zero", "2"), ("causal", "nn", "1"),
            ("noncausal", "shuffle", "1"), ("noncausal", "shuffle", "2"),
            ("nsf", "shuffle", "1")]


@pytest.mark.parametrize("kind,upsample,resblock", VOCODERS)
def test_vocoder_mapping_matches_jax(kind, upsample, resblock):
    """Each generator's ``params_from_torch`` (causal: shuffle, zero and
    deconv ups, resblocks 1 and 2; non-causal; NSF with its int strides)
    against JAX's, and one ``apply`` through both."""
    jm, pm = _vocoder(kind, upsample, resblock)
    p_np = _nsf_params(jm) if kind == "nsf" else numpy_params(jm.init, seed=36)
    sd = pm.params_to_torch(params_from_jax(p_np, "cpu"))
    jp = jm.params_from_torch(_numpy_sd(sd))
    _assert_same_tree(jp, p_np)
    pp = pm.params_from_torch(sd, device="cpu")
    _assert_same_tree(pp, jp)
    _assert_same_tree(pm.params_from_torch(_numpy_sd(sd), device="cpu"), jp)
    mel = np.random.default_rng(37).standard_normal((B, 8, 80)).astype(np.float32)
    _close(pm.apply(pp, _t(mel)), jax.jit(jm.apply)(jp, mel))


def test_diffnet_mapping_keeps_the_causal_taps():
    """DiffNet alone: the reference's masked k=3 conv is written with a zero
    third tap, and JAX's and the port's mappers keep taps 0 and 1."""
    jcfg = JDiffNetConfig(in_dims=1, encoder_hidden=16, residual_layers=3,
                          residual_channels=8, dilation_cycle_length=2)
    p_np = numpy_params(JDiffNet(jcfg).init, seed=38)
    net = DiffNet(DiffNetConfig(**dataclasses.asdict(jcfg)))
    sd = net.params_to_torch(params_from_jax(p_np, "cpu"), "pitch_flownet.")
    w = sd["pitch_flownet.residual_layers.2.dilated_conv.weight"]
    assert w.shape == (16, 8, 3) and not w[:, :, 2].any()
    sub = {k[len("pitch_flownet."):]: v for k, v in _numpy_sd(sd).items()}
    jp = JDiffNet(jcfg).params_from_torch(sub)
    _assert_same_tree(jp, p_np)
    _assert_same_tree(net.params_from_torch(sd, "pitch_flownet.", device="cpu"), jp)


def test_mismatched_tree_and_default_device():
    """The inverse refuses a tree that is not the mapping's, and the
    mappers, like every entry point, default to the card."""
    names = {"a": {"w": "a.weight"}, "b": ["b.0", "b.1"]}
    with pytest.raises(ValueError, match="keys"):
        state_dict_from_params({"a": {"w": torch.ones(1), "x": torch.ones(1)},
                                "b": [torch.ones(1)] * 2}, names)
    with pytest.raises(ValueError, match="entries"):
        state_dict_from_params({"a": {"w": torch.ones(1)}, "b": [torch.ones(1)]}, names)
    if not torch.cuda.is_available():
        jm, pm = _vocoder("causal")
        sd = pm.params_to_torch(params_from_jax(numpy_params(jm.init, seed=39), "cpu"))
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.params_from_torch(sd)


def test_scalar_leaves_stay_scalar(tmp_path):
    """A 0-d leaf (a step counter, the VQ's ``initialized`` flag) keeps its
    shape through a checkpoint and ``params_from_jax``, as in the JAX tree
    and the port's own init; ``np.ascontiguousarray`` made it shape (1,).
    The same for a state dict read through a name tree."""
    state = {"step": torch.tensor(7, dtype=torch.int32),
             "vq_state": {"initialized": torch.zeros(()), "ema_count": torch.ones(3)},
             "w": torch.arange(6.0).reshape(2, 3)[:, ::2]}
    save_checkpoint(str(tmp_path), 7, state)
    got = params_from_jax(load_ckpt_state(str(tmp_path)), "cpu")
    assert got["step"].shape == () and got["step"].dtype == torch.int32 and int(got["step"]) == 7
    assert got["vq_state"]["initialized"].shape == ()
    assert got["w"].is_contiguous() and torch.equal(got["w"], state["w"])
    flag = params_from_state_dict({"f": np.zeros((), np.float32)}, {"flag": "f"}, "cpu")
    assert flag["flag"].shape == ()
