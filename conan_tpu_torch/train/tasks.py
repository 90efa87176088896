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
gate decided on the device (nothing is read back to the host but, under
``accumulate_grad_batches``, the mini-step count). The step runs
on the task's device (None: the CUDA card). Random parts (dropout, the mel
discriminator's crops) are drawn from the ``torch.Generator`` the trainer
passes in, not from ``jax.random``'s stream; with none, dropout is off and
the crops start at frame 0.

VocoderTask: the MSD's grouped convs and the mel loss's log-mel launch
kernels K2 and K1 on the card; on the CPU their plain versions run. Its
options: ``generator_type: noncausal``, the conditional MPD and MSD
(``use_cond_disc``, with the rolled-mel negatives in the discriminator
loss), the spectrogram discriminator (``use_spec_disc``: the multi-window
mel discriminator with windows 8/16/32 over the 80-bin ln-mel that K1's GAN
form computes, its crops and Dropout2d drawn from the generator) and
feature matching (``use_fm_loss``). Two things differ from the JAX step,
neither in its result:
  - the generator's gradients are taken with respect to the generator's
    parameters only, so no discriminator weight gradient is computed in it;
  - without feature matching the generator loss needs only the
    discriminators' outputs on the generated wav, so the real wav's branch
    is not run (with it, the real branch runs without autograd: it does not
    depend on the generator). JAX computes that branch and XLA drops it as
    dead code; eager PyTorch would run it, half the generator step's
    discriminator work.

``accumulate_grad_batches`` k > 1 wraps both optimizers of VocoderTask and
ConanTask in ``optim.Accumulate`` (optax.MultiSteps): the parameters move on
every k-th mini-step, by the inner update of the mean gradient. The NaN
guard keeps or drops a whole mini-step, the accumulator with it, as JAX's
``_gated_update`` keeps or drops the whole MultiSteps state. EmformerTask
and PostnetTask ignore the option, as the JAX package's do.

ConanTask: the acoustic model against the multi-window mel discriminator,
with the L1 + SSIM mel loss, the F0 and UV losses, the guided-attention and
VQ losses, and the EMA codebook carried in the state (``vq_state``); with
``use_spk_id`` the speaker-id embedding is added to the style, and a batch
that carries ``spk_embed`` (the dataset's, with ``use_spk_embed``) takes it
as the style in place of the reference encoder's. Its
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

Data parallelism: every task takes a ``world`` (``parallel/dist.py``; None:
alone). Each rank's ``train_step`` gets its block of the padded global
batch, and the step on N ranks is the step on that whole batch:
  - the step runs with the world active, so every loss is this rank's share
    of the global batch's loss (masked means divided by counts summed over
    the ranks; spectral convergence and the discriminators' batch norm summed
    across the ranks with the gradient), the VQ sums its statistics across
    the ranks and the mel discriminator's longest utterance is the global
    batch's;
  - the gradients are summed across the ranks (one buffer per optimizer)
    before the NaN guard, the clip norm and ``Accumulate``, so every
    decision is global and the same on every rank; the step sorts the
    state's keys first (JAX's leaf order), so every rank flattens the same
    leaf order whatever order its tree was built in;
  - every per-row random draw (dropout, Dropout2d, the flow's step and noise)
    is made at the global batch's shape from the generator, which every rank
    seeds alike, and the rank keeps its rows; a scalar draw (a crop start) is
    one draw, the same on every rank;
  - the conditional discriminators' rolled mels roll over the global batch;
  - the metrics are the global batch's, summed from the ranks' shares in one
    all-reduce, the same on every rank.
ConanTask's k-means hook gathers the prosody rows of every rank in rank
order (the global batch's order), runs k-means on rank 0 and broadcasts the
codebook; its retry decision reads the gathered rows, so it is global.
"""

from __future__ import annotations

import torch

import numpy as np

from conan_tpu_torch.audio.mel import MelConfig
from conan_tpu_torch.checkpoint import params_from_jax, tree_leaves, tree_map, tree_unflatten
from conan_tpu_torch.device import resolve_device
from conan_tpu_torch.models.conan.model import Conan, ConanConfig
from conan_tpu_torch.models.conan.postnet import ConanPostnet, PostnetConfig
from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
from conan_tpu_torch.models.vocoder.discriminators import (MultiPeriodDiscriminator,
                                                           MultiScaleDiscriminator,
                                                           MultiWindowDiscriminator)
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
from conan_tpu_torch.models.vocoder.hifigan_noncausal import NonCausalHifiGanGenerator
from conan_tpu_torch.ops.logmel import logmel_gan
from conan_tpu_torch.ops.precision import TRAINING_RUNGS, training_scope
from conan_tpu_torch.parallel import dist
from conan_tpu_torch.train import losses as L
from conan_tpu_torch.train.optim import (AdamW, accumulating, build_schedule,
                                         emformer_distill_schedule, step_lr_schedule)


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
    parameters and the optimizer state as they were. Decided on the device.
    The new and old states are paired leaf by leaf in sorted key order (an
    optimizer builds its new state in its own key order)."""
    updates, opt_new, opt_old = (dist.sorted_keys(t) for t in (updates, opt_new, opt_old))
    new_params = tree_unflatten(params, [torch.where(ok, p + u, p) for p, u in
                                         zip(tree_leaves(params), tree_leaves(updates))])
    new_opt = tree_unflatten(opt_old, [torch.where(ok, n, o) for n, o in
                                       zip(tree_leaves(opt_new), tree_leaves(opt_old))])
    return new_params, new_opt


def _all_finite(grads) -> torch.Tensor:
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def _with_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _grads(loss: torch.Tensor, params, world: dist.World | None = None) -> list:
    """d loss / d each leaf of ``params``; zeros for a leaf the loss does not
    reach (a discriminator window too long for the batch), as JAX gives.
    Summed across the ranks of ``world``."""
    return dist.all_reduce_grads(torch.autograd.grad(loss, tree_leaves(params),
                                                     allow_unused=True,
                                                     materialize_grads=True), world)


def _device(device, world: dist.World | None) -> torch.device:
    """The task's device: ``device`` where given, else the world's, else
    the card."""
    return resolve_device(world.device if device is None and world is not None else device)


class VocoderTask:
    """The HiFi-GAN vocoder (``generator_type`` causal or noncausal) against
    the MPD and MSD (conditional with ``use_cond_disc``) and, with
    ``use_spec_disc``, the spectrogram discriminator, with the 320-bin
    multi-resolution mel loss, the multi-resolution STFT loss and, with
    ``use_fm_loss``, feature matching."""

    def __init__(self, hp, device: str | torch.device | None = None,
                 world: dist.World | None = None):
        self.hp = hp
        self.world = world
        self.device = _device(device, world)
        self.precision = training_rung(hp)
        cfg = HifiGanConfig.from_hparams(hp)
        gen_type = hp.get("generator_type", "causal")
        if gen_type not in ("causal", "noncausal"):
            raise ValueError(f"generator_type {gen_type!r} is not causal or noncausal")
        self.gen = HifiGanGenerator(cfg) if gen_type == "causal" \
            else NonCausalHifiGanGenerator(cfg)
        self.use_cond_disc = bool(hp.get("use_cond_disc", False))
        self.use_spec_disc = bool(hp.get("use_spec_disc", False))
        self.use_fm_loss = bool(hp.get("use_fm_loss", False))
        hop = hp.get("hop_size", 320)
        self.mpd = MultiPeriodDiscriminator(use_cond=self.use_cond_disc, hop=hop)
        self.msd = MultiScaleDiscriminator(use_cond=self.use_cond_disc, hop=hop)
        if self.use_spec_disc:
            # the reference's Discriminator(time_lengths=[8, 16, 32], 80, 128)
            # over an 80-bin loss mel (tasks/vocoder/hifigan.py:75-83,137-143)
            self.specd = MultiWindowDiscriminator(time_lengths=(8, 16, 32), freq_length=80,
                                                  hidden=128)
            self.spec_mel_cfg = MelConfig.from_hparams(hp)
        b1, b2 = hp.get("adam_b1", 0.8), hp.get("adam_b2", 0.99)
        acc = hp.get("accumulate_grad_batches", 1)

        def adamw(name: str, clip: float):
            sched = step_lr_schedule(hp[f"{name}_optimizer_params"]["lr"],
                                     hp[f"{name}_scheduler_params"]["step_size"],
                                     hp[f"{name}_scheduler_params"]["gamma"])
            return accumulating(AdamW(sched, b1=b1, b2=b2,
                                      clip_norm=hp.get(f"{name}_grad_norm", clip)), acc)

        self.opt_g = adamw("generator", 10.0)
        self.opt_d = adamw("discriminator", 1.0)

    def init_state(self, gen: torch.Generator) -> dict:
        """Random parameters (the JAX package's distributions) on the task's
        device, with fresh optimizer states."""
        to_dev = lambda tree: tree_map(lambda t: t.to(self.device), tree)  # noqa: E731
        pg = to_dev(self.gen.init(gen))
        pd = {"mpd": self.mpd.init(gen), "msd": self.msd.init(gen)}
        if self.use_spec_disc:
            pd["specd"] = self.specd.init(gen)
        pd = to_dev(pd)
        return {"params_g": pg, "params_d": pd, "opt_g": self.opt_g.init(pg),
                "opt_d": self.opt_d.init(pd),
                "step": torch.zeros((), dtype=torch.int32, device=self.device)}

    def _spec_mel(self, wav: torch.Tensor) -> torch.Tensor:
        """The spectrogram discriminator's 80-bin ln-mel [B, T // hop, 80]
        (JAX's ``wav2mel_gan``), through K1's GAN form."""
        return logmel_gan(wav, self.spec_mel_cfg)

    def _gen_losses(self, pg, pd, mel: torch.Tensor, y: torch.Tensor,
                    generator: torch.Generator | None = None):
        hp = self.hp
        y_ = self.gen.apply(pg, mel)[..., 0]                     # [B, T]
        cond = mel if self.use_cond_disc else None
        mlp = hp["mel_loss_param"]
        out = {"mel": L.multi_res_gan_mel_loss(
            y, y_, hp["audio_sample_rate"], mlp["mel_bin"], tuple(mlp["fft_sizes"]),
            tuple(mlp["hop_sizes"]), tuple(mlp["win_lengths"]), hp.get("lambda_mel", 5.0))}
        lam_adv = hp.get("lambda_adv", 1.0)
        ypg, fpg = self.mpd.forward(pd["mpd"], y_[..., None], cond)
        ysg, fsg = self.msd.forward(pd["msd"], y_[..., None], cond)
        out["a_p"] = L.generator_loss(ypg) * lam_adv
        out["a_s"] = L.generator_loss(ysg) * lam_adv
        if self.use_fm_loss:
            with torch.no_grad():           # the real branch: no generator parameter in it
                fpr = self.mpd.forward(pd["mpd"], y[..., None], cond)[1]
                fsr = self.msd.forward(pd["msd"], y[..., None], cond)[1]
            out["fm_f"] = L.feature_loss(fpr, fpg)
            out["fm_s"] = L.feature_loss(fsr, fsg)
        if self.use_spec_disc:
            # adversarial mel term (hifigan.py:152-158), skipped unless every
            # window fits
            v, _, _, fit = self.specd.apply(pd["specd"], self._spec_mel(y_), generator)
            out["a_mel"] = torch.where(fit, dist.batch_mean(torch.square(v - 1.0)), 0.0) \
                * hp.get("lambda_mel_adv", 1.0)
        if hp.get("use_ms_stft", False):
            sp = hp["stft_loss_param"]
            out["sc"], out["mag"] = L.multi_res_stft_loss(
                y, y_, tuple(sp["fft_sizes"]), tuple(sp["hop_sizes"]), tuple(sp["win_lengths"]))
        return sum(out.values()), out, y_

    def _disc_losses(self, pd, y: torch.Tensor, y_: torch.Tensor,
                     mel: torch.Tensor | None = None,
                     generator: torch.Generator | None = None):
        cond = mel if self.use_cond_disc else None
        out = {}
        ypr, ypg, _, _ = self.mpd.apply(pd["mpd"], y[..., None], y_[..., None], cond)
        out["r_p"], out["f_p"] = L.discriminator_loss(ypr, ypg)
        ysr, ysg, _, _ = self.msd.apply(pd["msd"], y[..., None], y_[..., None], cond)
        out["r_s"], out["f_s"] = L.discriminator_loss(ysr, ysg)
        if self.use_spec_disc:
            # real against generated on the 80-bin mels (hifigan.py:181-186),
            # fresh crops for each
            vr, _, _, fit_r = self.specd.apply(pd["specd"], self._spec_mel(y), generator)
            vf, _, _, fit_f = self.specd.apply(pd["specd"], self._spec_mel(y_), generator)
            fit = fit_r & fit_f
            out["r_mel"] = torch.where(fit, dist.batch_mean(torch.square(vr - 1.0)), 0.0)
            out["f_mel"] = torch.where(fit, dist.batch_mean(torch.square(vf)), 0.0)
        if self.use_cond_disc:
            # rolled-mel negatives: the real and the generated wav under
            # another item's mel are both "fake" (hifigan.py:187-196)
            mel_shift = dist.roll_rows(mel, -1)
            yp1, yp2, _, _ = self.mpd.apply(pd["mpd"], y[..., None], y_[..., None], mel_shift)
            out["f_p_cd1"] = L.cond_discriminator_loss(yp1)
            out["f_p_cd2"] = L.cond_discriminator_loss(yp2)
            ys1, ys2, _, _ = self.msd.apply(pd["msd"], y[..., None], y_[..., None], mel_shift)
            out["f_s_cd1"] = L.cond_discriminator_loss(ys1)
            out["f_s_cd2"] = L.cond_discriminator_loss(ys2)
        return sum(out.values()), out

    def train_step(self, state: dict, batch: dict, generator: torch.Generator | None = None
                   ) -> tuple[dict, dict]:
        """batch: mels [B, T, 80] and wavs [B, T·hop] (tensors or numpy).
        Returns the new state and the metrics, 0-dim tensors on the device.
        Only the spectrogram discriminator draws at random (its crops and
        Dropout2d, from ``generator``; with none, no dropout and crops at
        frame 0)."""
        state = dist.sorted_keys(state)
        with training_scope(self.precision, self.device), dist.scope(self.world):
            mel = torch.as_tensor(batch["mels"]).to(self.device)
            y = torch.as_tensor(batch["wavs"]).to(self.device)
            # ---- generator
            pg = _with_grad(state["params_g"])
            gtot, gl, y_ = self._gen_losses(pg, state["params_d"], mel, y, generator)
            grads_g = dist.all_reduce_grads(torch.autograd.grad(gtot, tree_leaves(pg)),
                                            self.world)
            ok_g = _all_finite(grads_g)
            upd_g, opt_g_new = self.opt_g.update(tree_unflatten(pg, grads_g), state["opt_g"])
            params_g, opt_g = _gated_update(ok_g, state["params_g"], upd_g, opt_g_new,
                                            state["opt_g"])
            # ---- discriminator, on the detached y_
            pd = _with_grad(state["params_d"])
            dtot, dl = self._disc_losses(pd, y, y_.detach(), mel, generator)
            grads_d = _grads(dtot, pd, self.world)
            ok_d = _all_finite(grads_d)
            upd_d, opt_d_new = self.opt_d.update(tree_unflatten(pd, grads_d), state["opt_d"])
            params_d, opt_d = _gated_update(ok_d, state["params_d"], upd_d, opt_d_new,
                                            state["opt_d"])
        metrics = dist.reduce_metrics({k: v.detach() for k, v in {
            **gl, **dl, "total_g": gtot, "total_d": dtot}.items()}, self.world)
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

    def __init__(self, hp, device: str | torch.device | None = None,
                 world: dist.World | None = None):
        self.hp = hp
        self.world = world
        self.device = _device(device, world)
        self.precision = training_rung(hp)
        self.cfg = ConanConfig.from_hparams(hp)
        self.model = Conan(self.cfg)
        self.mel_disc = MultiWindowDiscriminator(
            time_lengths=(32, 64, 128)[:hp.get("disc_win_num", 3)], freq_length=80,
            hidden=hp.get("mel_disc_hidden_size", 128))
        b1, b2 = hp.get("optimizer_adam_beta1", 0.9), hp.get("optimizer_adam_beta2", 0.98)
        clip = hp.get("clip_grad_norm", 1.0)
        acc = hp.get("accumulate_grad_batches", 1)
        self.opt_g = accumulating(AdamW(build_schedule(hp), b1=b1, b2=b2,
                                        weight_decay=hp.get("weight_decay", 0.0),
                                        clip_norm=clip), acc)
        dsp = hp.get("discriminator_scheduler_params", {"step_size": 40000, "gamma": 0.5})
        dop = hp.get("discriminator_optimizer_params", {"eps": 1e-6, "weight_decay": 0.0})
        self.opt_d = accumulating(AdamW(step_lr_schedule(hp.get("disc_lr", 1e-4),
                                                         dsp["step_size"], dsp["gamma"]),
                                        b1=b1, b2=b2, eps=dop.get("eps", 1e-6),
                                        weight_decay=dop.get("weight_decay", 0.0),
                                        clip_norm=clip), acc)

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
                                     generator=generator, spk_embed=batch.get("spk_embed"),
                                     spk_id=batch.get("spk_ids"))
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
        adv = dist.batch_mean(torch.square(v - 1.0)) * hp.get("lambda_mel_adv", 0.05)
        losses["a"] = torch.where(disc_on & fit, adv, 0.0)
        metrics = dict(losses)
        metrics["ppl"] = out["ppl"] if self.cfg.style else torch.zeros((), device=self.device)
        return sum(losses.values()), metrics, out

    def _disc_losses(self, pd, mel_g: torch.Tensor, mel_p: torch.Tensor, generator):
        # fresh crops for the real and the generated mels alike
        v_r, _, _, fit_r = self.mel_disc.apply(pd, mel_g, generator)
        v_f, _, _, fit_f = self.mel_disc.apply(pd, mel_p, generator)
        out = {"r": dist.batch_mean(torch.square(v_r - 1.0)),
               "f": dist.batch_mean(torch.square(v_f))}
        return out["r"] + out["f"], out, fit_r & fit_f

    def _batch(self, batch: dict, use_random_ref: bool) -> dict:
        """The batch's tensors on the device: the speaker ids with
        ``use_spk_id``, ``spk_embed`` where the batch has it."""
        keys = ("content", "mels", "f0", "uv") + (("ref_mels",) if use_random_ref else ())
        keys += ("spk_ids",) if self.cfg.use_spk_id else ()
        keys += ("spk_embed",) if "spk_embed" in batch else ()
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
        None, done)``. Under a world every rank's features are gathered in
        rank order, so every rank sees the global batch's rows and decides
        alike; rank 0 runs the k-means and broadcasts the codebook."""
        if not self.cfg.style or state.get("vq_state") is None:
            return None, True
        if float(state["vq_state"]["initialized"]) != 0.0:
            return None, True          # bootstrapped already
        with torch.no_grad(), training_scope(self.precision, self.device):
            ref = torch.as_tensor(batch["mels"]).to(self.device)
            feats = dist.all_gather_rows(
                self.model.prosody.pre_vq(state["params_g"]["prosody"], ref), self.world)
        flat = feats.reshape(-1, feats.shape[-1]).cpu().numpy()
        flat = flat[np.abs(flat).sum(-1) > 0]
        if len(flat) < self.cfg.n_vq:
            return None, False
        new_state = dict(state)
        vq = state["vq_state"]
        if self.world is None or self.world.rank == 0:
            vq = self.model.prosody.vq.kmeans_init_host(vq, flat)
        new_state["vq_state"] = dist.broadcast_state(vq, self.world)
        return new_state, True

    def train_step(self, state: dict, batch: dict, generator: torch.Generator | None = None,
                   use_random_ref: bool = False) -> tuple[dict, dict]:
        """batch: content [B, T] (-1 pads), mels [B, T, 80], f0 and uv [B, T],
        and ref_mels [B, Tr, 80] once ``use_random_ref`` (tensors or numpy).
        Returns the new state and the metrics, 0-dim tensors on the device."""
        hp = self.hp
        state = dist.sorted_keys(state)
        with training_scope(self.precision, self.device), dist.scope(self.world):
            b = self._batch(batch, use_random_ref)
            step = state["step"]
            # ---- generator
            pg = _with_grad(state["params_g"])
            gtot, gl, out = self._gen_losses(pg, state["params_d"], state["vq_state"], b, step,
                                             generator, use_random_ref)
            grads_g = _grads(gtot, pg, self.world)
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
            grads_d = _grads(dtot, pd, self.world)
            d_gate = disc_on & d_fit
            ok_d = _all_finite(grads_d) & d_gate
            upd_d, opt_d_new = self.opt_d.update(tree_unflatten(pd, grads_d), state["opt_d"],
                                                 state["params_d"])
            params_d, opt_d = _gated_update(ok_d, state["params_d"], upd_d, opt_d_new,
                                            state["opt_d"])
        shares = {k: v.detach() for k, v in gl.items() if k != "ppl"}
        shares.update({f"d_{k}": torch.where(d_gate, v, 0.0).detach() for k, v in dl.items()})
        shares["total_g"] = gtot.detach()
        metrics = {**dist.reduce_metrics(shares, self.world), "ppl": gl["ppl"].detach()}
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
                 device: str | torch.device | None = None, world: dist.World | None = None):
        self.hp = hp
        self.world = world
        self.device = _device(device, world)
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
        state and the metrics, 0-dim tensors on the device. The frozen
        model's tree passes through as given."""
        frozen = state["frozen"]
        state = dist.sorted_keys(state)
        with training_scope(self.precision, self.device), dist.scope(self.world):
            b = {k: torch.as_tensor(batch[k]).to(self.device)
                 for k in ("content", "mels", "ref_mels", "f0", "uv")}
            p = _with_grad(state["params"])
            loss = self._loss(p, state["frozen"], b, generator)
            grads = _grads(loss, p, self.world)
            ok = _all_finite(grads)
            upd, opt_new = self.opt.update(tree_unflatten(p, grads), state["opt"],
                                           state["params"])
            params, opt = _gated_update(ok, state["params"], upd, opt_new, state["opt"])
        return ({"params": params, "opt": opt, "step": state["step"] + 1,
                 "frozen": frozen},
                {**dist.reduce_metrics({"flow": loss.detach()}, self.world),
                 "skipped": 1.0 - ok.float()})


class EmformerTask:
    """The Emformer distilled from HuBERT codes: temperature-scaled CE times
    ``lambda_distillation`` over the codes that are not -1, AdamW with global
    norm clipping and ``emformer_distill_schedule``."""

    def __init__(self, hp, device: str | torch.device | None = None,
                 world: dist.World | None = None):
        self.hp = hp
        self.world = world
        self.device = _device(device, world)
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
        state = dist.sorted_keys(state)
        with training_scope(self.precision, self.device), dist.scope(self.world):
            p = _with_grad(state["params"])
            loss, acc = self._loss(p, batch)
            grads = _grads(loss, p, self.world)
            ok = _all_finite(grads)
            upd, opt_new = self.opt.update(tree_unflatten(p, grads), state["opt"],
                                           state["params"])
            params, opt = _gated_update(ok, state["params"], upd, opt_new, state["opt"])
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                {**dist.reduce_metrics({"ce": loss.detach(), "acc": acc.detach()}, self.world),
                 "skipped": 1.0 - ok.float()})
