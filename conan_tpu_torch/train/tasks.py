"""The training tasks (``conan_tpu/train/tasks.py``): the GANs ``VocoderTask``
(:54-219) and ``ConanTask`` (:223-373), ``PostnetTask`` (:381-423), the mel
postnet's flow on a frozen Conan, and ``EmformerTask`` (:429-475), the
content extractor's distillation.

Every step runs at the config's ``train_precision`` (``training_scope``:
"highest" fp32, "high" TF32, "default" bf16 operands for every dot and conv
with the rest in fp32), as does ``ConanTask``'s k-means hook.

Each ``train_step`` is one functional step over a state tree with the JAX
package's key paths: the generator update, then the discriminator update on
the detached generator output, each behind the NaN guard, with every schedule
gate decided on the device (nothing is read back to the host). The step runs
on the task's device (None: the CUDA card). Random parts (dropout, the mel
discriminator's crops) are drawn from the ``torch.Generator`` the trainer
passes in, not from ``jax.random``'s stream; with none, dropout is off and
the crops start at frame 0.

VocoderTask: the MSD's grouped convs and the mel loss's log-mel launch
kernels K2 and K1 on the card; on the CPU their plain versions run. Two
things differ from the JAX step, neither in its result:
  - the generator's gradients are taken with respect to the generator's
    parameters only, so no discriminator weight gradient is computed in it;
  - without feature matching the generator loss needs only the
    discriminators' outputs on the generated wav, so the real wav's branch
    is not run. JAX computes that branch and XLA drops it as dead code; eager
    PyTorch would run it, half the generator step's discriminator work.

ConanTask: the acoustic model against the multi-window mel discriminator,
with the L1 + SSIM mel loss, the F0 and UV losses, the guided-attention and
VQ losses, and the EMA codebook carried in the state (``vq_state``). Its
``host_hook`` bootstraps the codebook by k-means once, on the host. Its
mels come from the binarizer, where K1 made them; the step itself runs no
hand-written kernel. The generator's gradients are again taken with respect
to its own parameters only.

PostnetTask: the frozen Conan (its parameters and VQ state ride in the
state under ``frozen``) gives the coarse mel and ``decoder_inp`` without
gradients, as the JAX package's ``apply(infer=False, global_step=200000)``
does: ground-truth F0 and UV, the VQ on, the aligner not forced, no dropout,
its VQ EMA update thrown away. The postnet's velocity loss draws its step
and noise from the generator.

EmformerTask: the offline Emformer and its code head against the teacher's
codes, the masked CE and accuracy. Its mels too come from the binarizer
(K1); the step draws nothing at random.
"""

from __future__ import annotations

import torch

import numpy as np

from conan_tpu_torch.checkpoint import params_from_jax, tree_leaves, tree_map, tree_unflatten
from conan_tpu_torch.device import resolve_device
from conan_tpu_torch.models.conan.model import Conan, ConanConfig
from conan_tpu_torch.models.conan.postnet import ConanPostnet, PostnetConfig
from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
from conan_tpu_torch.models.vocoder.discriminators import (MultiPeriodDiscriminator,
                                                           MultiScaleDiscriminator,
                                                           MultiWindowDiscriminator)
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
from conan_tpu_torch.ops.precision import TRAINING_RUNGS, training_scope
from conan_tpu_torch.train import losses as L
from conan_tpu_torch.train.optim import (AdamW, build_schedule, emformer_distill_schedule,
                                         step_lr_schedule)

NOT_PORTED = "is not ported yet (ROADMAP.md, modules still to port: {})"


def training_rung(hp) -> str:
    """The config's ``train_precision`` (``ops/precision.py``
    ``TRAINING_RUNGS``); "highest" where it names none, the JAX package's
    default."""
    name = hp.get("train_precision", "highest")
    if name not in TRAINING_RUNGS:
        raise ValueError(f"unknown train_precision {name!r}, not one of {TRAINING_RUNGS}")
    return name


def _gated_update(ok: torch.Tensor, params, updates, opt_new: dict, opt_old: dict):
    """NaN guard (reference trainer.py:356-363): unless ``ok``, keep both the
    parameters and the optimizer state as they were. Decided on the device."""
    new_params = tree_unflatten(params, [torch.where(ok, p + u, p) for p, u in
                                         zip(tree_leaves(params), tree_leaves(updates))])
    new_opt = tree_unflatten(opt_old, [torch.where(ok, n, o) for n, o in
                                       zip(tree_leaves(opt_new), tree_leaves(opt_old))])
    return new_params, new_opt


def _all_finite(grads) -> torch.Tensor:
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def _with_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _grads(loss: torch.Tensor, params) -> list:
    """d loss / d each leaf of ``params``; zeros for a leaf the loss does not
    reach (a discriminator window too long for the batch), as JAX gives."""
    return list(torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                    materialize_grads=True))


def _refuse_accumulation(hp) -> None:
    if hp.get("accumulate_grad_batches", 1) != 1:
        raise NotImplementedError("accumulate_grad_batches > 1 "
                                  + NOT_PORTED.format("the trainer's options"))


class VocoderTask:
    """The causal HiFi-GAN vocoder against the MPD and MSD, with the 320-bin
    multi-resolution mel loss and the multi-resolution STFT loss."""

    def __init__(self, hp, device: str | torch.device | None = None):
        for flag, item in (("use_cond_disc", "the conditional discriminators"),
                           ("use_spec_disc", "the spectrogram discriminator"),
                           ("use_fm_loss", "feature matching in the vocoder GAN")):
            if hp.get(flag, False):
                raise NotImplementedError(f"{flag} " + NOT_PORTED.format(item))
        if hp.get("generator_type", "causal") != "causal":
            raise NotImplementedError(f"generator_type {hp['generator_type']!r} "
                                      + NOT_PORTED.format("RMVPE and the other vocoders"))
        _refuse_accumulation(hp)
        self.hp = hp
        self.device = resolve_device(device)
        self.precision = training_rung(hp)
        self.gen = HifiGanGenerator(HifiGanConfig.from_hparams(hp))
        self.mpd = MultiPeriodDiscriminator()
        self.msd = MultiScaleDiscriminator()
        b1, b2 = hp.get("adam_b1", 0.8), hp.get("adam_b2", 0.99)

        def adamw(name: str, clip: float) -> AdamW:
            sched = step_lr_schedule(hp[f"{name}_optimizer_params"]["lr"],
                                     hp[f"{name}_scheduler_params"]["step_size"],
                                     hp[f"{name}_scheduler_params"]["gamma"])
            return AdamW(sched, b1=b1, b2=b2, clip_norm=hp.get(f"{name}_grad_norm", clip))

        self.opt_g = adamw("generator", 10.0)
        self.opt_d = adamw("discriminator", 1.0)

    def init_state(self, gen: torch.Generator) -> dict:
        """Random parameters (the JAX package's distributions) on the task's
        device, with fresh optimizer states."""
        to_dev = lambda tree: tree_map(lambda t: t.to(self.device), tree)  # noqa: E731
        pg = to_dev(self.gen.init(gen))
        pd = to_dev({"mpd": self.mpd.init(gen), "msd": self.msd.init(gen)})
        return {"params_g": pg, "params_d": pd, "opt_g": self.opt_g.init(pg),
                "opt_d": self.opt_d.init(pd),
                "step": torch.zeros((), dtype=torch.int32, device=self.device)}

    def _gen_losses(self, pg, pd, mel: torch.Tensor, y: torch.Tensor):
        hp = self.hp
        y_ = self.gen.apply(pg, mel)[..., 0]                     # [B, T]
        mlp = hp["mel_loss_param"]
        out = {"mel": L.multi_res_gan_mel_loss(
            y, y_, hp["audio_sample_rate"], mlp["mel_bin"], tuple(mlp["fft_sizes"]),
            tuple(mlp["hop_sizes"]), tuple(mlp["win_lengths"]), hp.get("lambda_mel", 5.0))}
        lam_adv = hp.get("lambda_adv", 1.0)
        out["a_p"] = L.generator_loss(self.mpd.forward(pd["mpd"], y_[..., None])[0]) * lam_adv
        out["a_s"] = L.generator_loss(self.msd.forward(pd["msd"], y_[..., None])[0]) * lam_adv
        if hp.get("use_ms_stft", False):
            sp = hp["stft_loss_param"]
            out["sc"], out["mag"] = L.multi_res_stft_loss(
                y, y_, tuple(sp["fft_sizes"]), tuple(sp["hop_sizes"]), tuple(sp["win_lengths"]))
        return sum(out.values()), out, y_

    def _disc_losses(self, pd, y: torch.Tensor, y_: torch.Tensor):
        out = {}
        ypr, ypg, _, _ = self.mpd.apply(pd["mpd"], y[..., None], y_[..., None])
        out["r_p"], out["f_p"] = L.discriminator_loss(ypr, ypg)
        ysr, ysg, _, _ = self.msd.apply(pd["msd"], y[..., None], y_[..., None])
        out["r_s"], out["f_s"] = L.discriminator_loss(ysr, ysg)
        return sum(out.values()), out

    def train_step(self, state: dict, batch: dict, generator: torch.Generator | None = None
                   ) -> tuple[dict, dict]:
        """batch: mels [B, T, 80] and wavs [B, T·hop] (tensors or numpy).
        Returns the new state and the metrics, 0-dim tensors on the device.
        The vocoder step draws nothing at random; ``generator`` is taken so
        that the trainer calls every task alike."""
        with training_scope(self.precision, self.device):
            mel = torch.as_tensor(batch["mels"]).to(self.device)
            y = torch.as_tensor(batch["wavs"]).to(self.device)
            # ---- generator
            pg = _with_grad(state["params_g"])
            gtot, gl, y_ = self._gen_losses(pg, state["params_d"], mel, y)
            grads_g = torch.autograd.grad(gtot, tree_leaves(pg))
            ok_g = _all_finite(grads_g)
            upd_g, opt_g_new = self.opt_g.update(tree_unflatten(pg, grads_g), state["opt_g"])
            params_g, opt_g = _gated_update(ok_g, state["params_g"], upd_g, opt_g_new,
                                            state["opt_g"])
            # ---- discriminator, on the detached y_
            pd = _with_grad(state["params_d"])
            dtot, dl = self._disc_losses(pd, y, y_.detach())
            grads_d = torch.autograd.grad(dtot, tree_leaves(pd))
            ok_d = _all_finite(grads_d)
            upd_d, opt_d_new = self.opt_d.update(tree_unflatten(pd, grads_d), state["opt_d"])
            params_d, opt_d = _gated_update(ok_d, state["params_d"], upd_d, opt_d_new,
                                            state["opt_d"])
        metrics = {k: v.detach() for k, v in {**gl, **dl, "total_g": gtot,
                                               "total_d": dtot}.items()}
        metrics["skipped"] = 1.0 - ok_g.float()
        return {"params_g": params_g, "params_d": params_d, "opt_g": opt_g, "opt_d": opt_d,
                "step": state["step"] + 1}, metrics


class ConanTask:
    """The Conan acoustic GAN (``f0_gen: orig``) against the multi-window mel
    discriminator (windows 32/64/128, ``disc_win_num`` of them). Generator:
    AdamW with ``build_schedule``'s LR and ``clip_grad_norm``; discriminator:
    AdamW (eps 1e-6) with StepLR. The schedule gates ``vq_start``,
    ``forcing``, ``disc_start_steps``, ``disc_interval`` and
    ``random_speaker_steps`` are read against the state's step on the
    device; ``random_speaker_steps`` also sets, on the host, when the trainer
    flips ``use_random_ref`` (the reference changes length)."""

    def __init__(self, hp, device: str | torch.device | None = None):
        for flag, item in (("use_spk_id", "the speaker-id embedding"),
                           ("use_spk_embed", "pre-extracted speaker embeddings")):
            if hp.get(flag, False):
                raise NotImplementedError(f"{flag} " + NOT_PORTED.format(item))
        _refuse_accumulation(hp)
        self.hp = hp
        self.device = resolve_device(device)
        self.precision = training_rung(hp)
        self.cfg = ConanConfig.from_hparams(hp)
        self.model = Conan(self.cfg)
        self.mel_disc = MultiWindowDiscriminator(
            time_lengths=(32, 64, 128)[:hp.get("disc_win_num", 3)], freq_length=80,
            hidden=hp.get("mel_disc_hidden_size", 128))
        b1, b2 = hp.get("optimizer_adam_beta1", 0.9), hp.get("optimizer_adam_beta2", 0.98)
        clip = hp.get("clip_grad_norm", 1.0)
        self.opt_g = AdamW(build_schedule(hp), b1=b1, b2=b2,
                           weight_decay=hp.get("weight_decay", 0.0), clip_norm=clip)
        dsp = hp.get("discriminator_scheduler_params", {"step_size": 40000, "gamma": 0.5})
        dop = hp.get("discriminator_optimizer_params", {"eps": 1e-6, "weight_decay": 0.0})
        self.opt_d = AdamW(step_lr_schedule(hp.get("disc_lr", 1e-4), dsp["step_size"],
                                            dsp["gamma"]),
                           b1=b1, b2=b2, eps=dop.get("eps", 1e-6),
                           weight_decay=dop.get("weight_decay", 0.0), clip_norm=clip)

    def init_state(self, gen: torch.Generator) -> dict:
        """Random parameters (the JAX package's distributions) and the
        codebook on the task's device, with fresh optimizer states."""
        to_dev = lambda tree: tree_map(lambda t: t.to(self.device), tree)  # noqa: E731
        pg = to_dev(self.model.init(gen))
        vq = to_dev(self.model.init_vq_state(gen)) if self.cfg.style else None
        pd = to_dev(self.mel_disc.init(gen))
        return {"params_g": pg, "params_d": pd, "vq_state": vq, "opt_g": self.opt_g.init(pg),
                "opt_d": self.opt_d.init(pd),
                "step": torch.zeros((), dtype=torch.int32, device=self.device)}

    def _gen_losses(self, pg, pd, vq_state, batch: dict, step: torch.Tensor,
                    generator, use_random_ref: bool):
        hp = self.hp
        content, target = batch["content"], batch["mels"]
        # the same utterance as reference until random_speaker_steps, then
        # another of the same speaker (tasks/Conan/Conan.py:76-79)
        ref = batch["ref_mels"] if use_random_ref else target
        out = self.model.apply_train(pg, vq_state, content, ref, batch["f0"], batch["uv"],
                                     global_step=step, vq_start=hp.get("vq_start", 20500),
                                     forcing_steps=hp.get("forcing", 20000),
                                     generator=generator)
        losses: dict = {}
        L.add_mel_losses(out["mel_out"], target, hp.get("mel_losses", "l1:0.5|ssim:0.5"),
                         losses)
        f0_loss = "pflow" if self.cfg.f0_gen == "flow" else "fdiff"
        losses[f0_loss] = out[f0_loss]
        losses["uv"] = L.masked_bce_with_logits(out["uv_pred"][:, :, 0], batch["uv"],
                                                (content != -1).to(target.dtype),
                                                hp.get("lambda_uv", 1.0))
        if self.cfg.style:
            gloss_on = (step > hp.get("forcing", 20000)) & (
                step < hp.get("random_speaker_steps", 100000))
            losses["gloss"] = torch.where(gloss_on, out["gloss"], 0.0)
            losses["vq_loss"] = torch.where(step > hp.get("vq_start", 20500), out["vq_loss"], 0.0)
        # the adversarial mel loss from disc_start_steps on, and only when
        # every window fits (the reference's validity=None skip)
        disc_on = step >= hp.get("disc_start_steps", 40000)
        v, _, _, fit = self.mel_disc.apply(pd, out["mel_out"], generator)
        adv = torch.mean(torch.square(v - 1.0)) * hp.get("lambda_mel_adv", 0.05)
        losses["a"] = torch.where(disc_on & fit, adv, 0.0)
        metrics = dict(losses)
        metrics["ppl"] = out["ppl"] if self.cfg.style else torch.zeros((), device=self.device)
        return sum(losses.values()), metrics, out

    def _disc_losses(self, pd, mel_g: torch.Tensor, mel_p: torch.Tensor, generator):
        # fresh crops for the real and the generated mels alike
        v_r, _, _, fit_r = self.mel_disc.apply(pd, mel_g, generator)
        v_f, _, _, fit_f = self.mel_disc.apply(pd, mel_p, generator)
        out = {"r": torch.mean(torch.square(v_r - 1.0)), "f": torch.mean(torch.square(v_f))}
        return out["r"] + out["f"], out, fit_r & fit_f

    def _batch(self, batch: dict, use_random_ref: bool) -> dict:
        keys = ("content", "mels", "f0", "uv") + (("ref_mels",) if use_random_ref else ())
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in keys}

    def host_hook(self, state: dict, step: int, batch: dict):
        """The one-time k-means bootstrap of the codebook (the reference's
        data-dependent init on the first VQ batch, prosody_util.py:56-65),
        which the trainer runs before each step from ``vq_start + 1`` on
        until it reports done. The batch's target mels (the same-utterance
        phase) go through ``pre_vq`` on the device; the nonzero feature rows
        come back to the host for scipy's k-means. A batch with fewer rows
        than codewords defers to the next batch. Reads back only the
        ``initialized`` flag and the feature matrix. Returns ``(new state or
        None, done)``."""
        if not self.cfg.style or state.get("vq_state") is None:
            return None, True
        if float(state["vq_state"]["initialized"]) != 0.0:
            return None, True          # bootstrapped already
        with torch.no_grad(), training_scope(self.precision, self.device):
            ref = torch.as_tensor(batch["mels"]).to(self.device)
            feats = self.model.prosody.pre_vq(state["params_g"]["prosody"], ref)
        flat = feats.reshape(-1, feats.shape[-1]).cpu().numpy()
        flat = flat[np.abs(flat).sum(-1) > 0]
        if len(flat) < self.cfg.n_vq:
            return None, False
        new_state = dict(state)
        new_state["vq_state"] = self.model.prosody.vq.kmeans_init_host(state["vq_state"], flat)
        return new_state, True

    def train_step(self, state: dict, batch: dict, generator: torch.Generator | None = None,
                   use_random_ref: bool = False) -> tuple[dict, dict]:
        """batch: content [B, T] (-1 pads), mels [B, T, 80], f0 and uv [B, T],
        and ref_mels [B, Tr, 80] once ``use_random_ref`` (tensors or numpy).
        Returns the new state and the metrics, 0-dim tensors on the device."""
        hp = self.hp
        with training_scope(self.precision, self.device):
            b = self._batch(batch, use_random_ref)
            step = state["step"]
            # ---- generator
            pg = _with_grad(state["params_g"])
            gtot, gl, out = self._gen_losses(pg, state["params_d"], state["vq_state"], b, step,
                                             generator, use_random_ref)
            grads_g = _grads(gtot, pg)
            ok_g = _all_finite(grads_g)
            upd_g, opt_g_new = self.opt_g.update(tree_unflatten(pg, grads_g), state["opt_g"],
                                                 state["params_g"])
            params_g, opt_g = _gated_update(ok_g, state["params_g"], upd_g, opt_g_new,
                                            state["opt_g"])
            vq_state = tree_map(torch.Tensor.detach, out["vq_state"]) if self.cfg.style else None
            # ---- discriminator, on the detached mel_out: from
            # disc_start_steps, on the disc_interval grid, when the windows fit
            disc_on = (step >= hp.get("disc_start_steps", 40000)) & (
                step % hp.get("disc_interval", 1) == 0)
            pd = _with_grad(state["params_d"])
            dtot, dl, d_fit = self._disc_losses(pd, b["mels"], out["mel_out"].detach(),
                                                generator)
            grads_d = _grads(dtot, pd)
            d_gate = disc_on & d_fit
            ok_d = _all_finite(grads_d) & d_gate
            upd_d, opt_d_new = self.opt_d.update(tree_unflatten(pd, grads_d), state["opt_d"],
                                                 state["params_d"])
            params_d, opt_d = _gated_update(ok_d, state["params_d"], upd_d, opt_d_new,
                                            state["opt_d"])
        metrics = {k: v.detach() for k, v in gl.items()}
        metrics.update({f"d_{k}": torch.where(d_gate, v, 0.0).detach() for k, v in dl.items()})
        metrics["total_g"] = gtot.detach()
        metrics["skipped"] = 1.0 - ok_g.float()
        return {"params_g": params_g, "params_d": params_d, "vq_state": vq_state,
                "opt_g": opt_g, "opt_d": opt_d, "step": step + 1}, metrics


class PostnetTask:
    """The mel postnet's rectified flow trained on a frozen Conan: AdamW (b1
    0.9, b2 0.98, eps 1e-9, ``clip_grad_norm``) on a StepLR of ``lr`` halved
    every ``decay_steps``; metrics ``flow`` and ``skipped``.
    ``pretrain_params`` and ``pretrain_vq_state`` are the Conan checkpoint's
    ``params_g`` and ``vq_state``, numpy trees as a checkpoint holds them."""

    def __init__(self, hp, pretrain_params, pretrain_vq_state,
                 device: str | torch.device | None = None):
        _refuse_accumulation(hp)
        self.hp = hp
        self.device = resolve_device(device)
        self.precision = training_rung(hp)
        self.conan = Conan(ConanConfig.from_hparams(hp))
        self.frozen = {"conan": params_from_jax(pretrain_params, self.device),
                       "vq": (None if pretrain_vq_state is None
                              else params_from_jax(pretrain_vq_state, self.device))}
        self.postnet = ConanPostnet(PostnetConfig.from_hparams(hp))
        self.opt = AdamW(step_lr_schedule(hp["lr"], hp.get("decay_steps", 50000), 0.5),
                         b1=0.9, b2=0.98, eps=1e-9, clip_norm=hp.get("clip_grad_norm", 1.0))

    def init_state(self, gen: torch.Generator) -> dict:
        """Random postnet parameters (the JAX package's distributions) on the
        task's device, a fresh optimizer state and the frozen Conan."""
        p = tree_map(lambda t: t.to(self.device), self.postnet.init(gen))
        return {"params": p, "opt": self.opt.init(p),
                "step": torch.zeros((), dtype=torch.int32, device=self.device),
                "frozen": self.frozen}

    def frozen_forward(self, frozen: dict, batch: dict) -> dict:
        """The frozen Conan's training forward at step 200000, without
        gradients (its ``mel_out`` and ``decoder_inp``)."""
        with torch.no_grad():
            return self.conan.apply_train(
                frozen["conan"], frozen["vq"], batch["content"], batch["ref_mels"],
                batch["f0"], batch["uv"], global_step=torch.tensor(200000, device=self.device),
                vq_start=self.hp.get("vq_start", 20500),
                forcing_steps=self.hp.get("forcing", 20000))

    def _loss(self, params, frozen: dict, batch: dict, generator) -> torch.Tensor:
        out = self.frozen_forward(frozen, batch)
        t, x0 = self.postnet.flow.draws(self.postnet.target(batch["mels"]), generator)
        return self.postnet.loss(params, out["mel_out"], out["decoder_inp"], batch["mels"],
                                 t, x0)

    def train_step(self, state: dict, batch: dict, generator: torch.Generator | None = None
                   ) -> tuple[dict, dict]:
        """batch: content [B, T] (-1 pads), mels [B, T, 80], ref_mels
        [B, Tr, 80], f0 and uv [B, T] (tensors or numpy). Returns the new
        state and the metrics, 0-dim tensors on the device."""
        with training_scope(self.precision, self.device):
            b = {k: torch.as_tensor(batch[k]).to(self.device)
                 for k in ("content", "mels", "ref_mels", "f0", "uv")}
            p = _with_grad(state["params"])
            loss = self._loss(p, state["frozen"], b, generator)
            grads = _grads(loss, p)
            ok = _all_finite(grads)
            upd, opt_new = self.opt.update(tree_unflatten(p, grads), state["opt"],
                                           state["params"])
            params, opt = _gated_update(ok, state["params"], upd, opt_new, state["opt"])
        return ({"params": params, "opt": opt, "step": state["step"] + 1,
                 "frozen": state["frozen"]},
                {"flow": loss.detach(), "skipped": 1.0 - ok.float()})


class EmformerTask:
    """The Emformer distilled from HuBERT codes: temperature-scaled CE times
    ``lambda_distillation`` over the codes that are not -1, AdamW with global
    norm clipping and ``emformer_distill_schedule``."""

    def __init__(self, hp, device: str | torch.device | None = None):
        _refuse_accumulation(hp)
        self.hp = hp
        self.device = resolve_device(device)
        self.precision = training_rung(hp)
        self.cfg = EmformerConfig.from_hparams(hp)
        self.model = EmformerDistillModel(self.cfg)
        sched = emformer_distill_schedule(
            hp["lr"], hp.get("warmup_steps", 20000), float(hp.get("warmup_init_lr", 1e-7)),
            hp.get("lr_decay", 0.995), hp.get("decay_interval", 2500),
            float(hp.get("min_lr", 1e-6)))
        self.opt = AdamW(sched, b1=hp.get("optimizer_adam_beta1", 0.9),
                         b2=hp.get("optimizer_adam_beta2", 0.98),
                         weight_decay=hp.get("weight_decay", 0.0),
                         clip_norm=hp.get("clip_grad_norm", 1.0))

    def init_state(self, gen: torch.Generator) -> dict:
        """Random parameters (the JAX package's distributions) on the task's
        device, with a fresh optimizer state."""
        p = tree_map(lambda t: t.to(self.device), self.model.init(gen))
        return {"params": p, "opt": self.opt.init(p),
                "step": torch.zeros((), dtype=torch.int32, device=self.device)}

    def _loss(self, params, batch: dict):
        """(CE × lambda_distillation, accuracy) of mels [B, T_in, 80] (the rc
        lookahead included) against content codes [B, T_utt] (-1 pads and
        each sample's rc tail, from the collate), both cut to one length. No
        attention lengths: every key is valid, the -1 codes carry validity."""
        mel = torch.as_tensor(batch["mels"]).to(self.device)
        codes = torch.as_tensor(batch["content"]).to(self.device)
        logits = self.model.apply(params, mel)
        T = min(logits.shape[1], codes.shape[1])
        logits, codes = logits[:, :T], codes[:, :T]
        mask = codes != -1
        loss = L.distillation_loss(logits, codes, mask,
                                   float(self.hp.get("distillation_temperature", 1.0)))
        return (loss * float(self.hp.get("lambda_distillation", 1.0)),
                L.distillation_accuracy(logits, codes, mask))

    def train_step(self, state: dict, batch: dict, generator: torch.Generator | None = None
                   ) -> tuple[dict, dict]:
        """batch: mels [B, T_in, 80] and content [B, T_utt] (tensors or
        numpy). Returns the new state and the metrics ``ce``, ``acc`` and
        ``skipped``, 0-dim tensors on the device. The step draws nothing at
        random; ``generator`` is taken so that the trainer calls every task
        alike."""
        with training_scope(self.precision, self.device):
            p = _with_grad(state["params"])
            loss, acc = self._loss(p, batch)
            grads = _grads(loss, p)
            ok = _all_finite(grads)
            upd, opt_new = self.opt.update(tree_unflatten(p, grads), state["opt"],
                                           state["params"])
            params, opt = _gated_update(ok, state["params"], upd, opt_new, state["opt"])
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                {"ce": loss.detach(), "acc": acc.detach(), "skipped": 1.0 - ok.float()})
