"""Validation functions, one per task (``conan_tpu/train/validation.py``).

Each ``make_*_valid_fn(task, batches, ...)`` returns ``valid_fn(state,
step) -> dict`` of the mean metrics over the fixed batches, with
``val_loss`` the total the trainer monitors. ``state`` is the task's state
tree of tensors on its device. The batches run under ``torch.no_grad`` at
the task's training precision; nothing is drawn at random (the JAX package
passes keys, but inference with ``infer=True`` on the ``orig`` F0 path and
the vocoder's generator losses draw nothing).

  emformer  CE and accuracy, and for the first batches the predicted and
            the teacher's codes as text under ``<work_dir>/valid_codes``
  conan     full-utterance inference on single-item batches: the mel losses,
            a gt/pred mel plot under ``<work_dir>/valid_plots`` where
            matplotlib imports, and the predicted (and once the gt) wav
            through a vocoder under ``<work_dir>/valid_wavs``
  vocoder   the generator's losses
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from conan_tpu_torch.audio.pitch import denorm_f0
from conan_tpu_torch.ops.precision import training_scope
from conan_tpu_torch.train import losses as L


@contextlib.contextmanager
def _eval_scope(task):
    with torch.no_grad(), training_scope(task.precision, task.device):
        yield


def _save_mel_plot(work_dir: str, step: int, idx: int, mel_pred: np.ndarray,
                   mel_gt: np.ndarray, f0_gt: np.ndarray | None = None,
                   f0_pred: np.ndarray | None = None) -> None:
    """The gt and predicted mels ([M, T] each) with their F0 curves over
    them (0-900 Hz across the mel bins), as ``valid_plots/step<N>_b<i>.png``;
    nothing where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    d = os.path.join(work_dir, "valid_plots")
    os.makedirs(d, exist_ok=True)
    fig, axes = plt.subplots(2, 1, figsize=(10, 5), sharex=True)
    for ax, mel, f0, title in ((axes[0], mel_gt, f0_gt, "gt"), (axes[1], mel_pred, f0_pred,
                                                                  "pred")):
        ax.imshow(mel, origin="lower", aspect="auto")
        ax.set_title(title)
        if f0 is not None:
            curve = np.where(f0 > 0, f0 / 900.0 * (mel_gt.shape[0] - 1), np.nan)
            ax.plot(curve[: mel_gt.shape[1]], color="white", lw=0.8)
    fig.tight_layout()
    fig.savefig(os.path.join(d, f"step{step}_b{idx}.png"), dpi=80)
    plt.close(fig)


def make_emformer_valid_fn(task, valid_batches: list[dict], work_dir: str | None = None,
                           num_dumps: int = 2):
    def valid_fn(state, step: int) -> dict:
        ce, acc = 0.0, 0.0
        with _eval_scope(task):
            for bi, batch in enumerate(valid_batches):
                loss, a = task._loss(state["params"], batch)
                ce += float(loss)
                acc += float(a)
                if work_dir is not None and bi < num_dumps:
                    mel = torch.as_tensor(batch["mels"]).to(task.device)
                    pred = torch.argmax(task.model.apply(state["params"], mel), -1)[0]
                    gt = np.asarray(batch["content"][0])
                    valid = gt != -1
                    d = os.path.join(work_dir, "valid_codes")
                    os.makedirs(d, exist_ok=True)
                    with open(os.path.join(d, f"step{step}_b{bi}.txt"), "w") as f:
                        f.write("gt:   " + " ".join(map(str, gt[valid])) + "\n")
                        f.write("pred: " + " ".join(map(str, pred.cpu().numpy()[: len(gt)][valid]))
                                + "\n")
        n = max(len(valid_batches), 1)
        return {"ce": ce / n, "acc": acc / n, "val_loss": ce / n}

    valid_fn.batches = valid_batches
    return valid_fn


def make_conan_valid_fn(task, valid_batches: list[dict], *, work_dir: str | None = None,
                        vocoder=None, vocoder_params=None, num_plots: int = 4,
                        sample_rate: int = 16000, infer_interval: int = 1):
    """Plots and wavs on the first ``num_plots`` batches of a validation
    where ``step % infer_interval == 0`` or ``step <= infer_interval`` (so a
    short run leaves some), the JAX package's rule."""
    from conan_tpu_torch.infer.run_vc import save_wav

    def valid_fn(state, step: int) -> dict:
        metrics: dict[str, float] = {}
        plots = num_plots if (step % max(infer_interval, 1) == 0
                              or step <= infer_interval) else 0
        dev = task.device
        with _eval_scope(task):
            for bi, batch in enumerate(valid_batches):
                mels = torch.as_tensor(batch["mels"]).to(dev)
                out = task.model.apply(state["params_g"],
                                       torch.as_tensor(batch["content"]).to(dev),
                                       ref=torch.as_tensor(batch["ref_mels"]).to(dev),
                                       vq_state=state["vq_state"])
                losses: dict = {}
                L.add_mel_losses(out["mel_out"], mels,
                                 task.hp.get("mel_losses", "l1:0.5|ssim:0.5"), losses)
                for k, v in losses.items():
                    metrics[k] = metrics.get(k, 0.0) + float(v)
                metrics["val_loss"] = metrics.get("val_loss", 0.0) + float(sum(losses.values()))
                if work_dir is None or bi >= plots:
                    continue
                f0_gt = None
                if "f0" in batch and "uv" in batch:
                    f0_gt = denorm_f0(torch.as_tensor(batch["f0"][0]),
                                      torch.as_tensor(batch["uv"][0])).numpy()
                _save_mel_plot(work_dir, step, bi, out["mel_out"][0].cpu().numpy().T,
                               np.asarray(batch["mels"][0]).T, f0_gt=f0_gt,
                               f0_pred=out["f0_denorm_pred"][0].cpu().numpy())
                if vocoder is None:
                    continue
                d = os.path.join(work_dir, "valid_wavs")
                os.makedirs(d, exist_ok=True)
                wav_p = vocoder.apply(vocoder_params, out["mel_out"][:1])
                save_wav(os.path.join(d, f"step{step}_b{bi}_pred.wav"),
                         wav_p[0, :, 0].cpu().numpy(), sample_rate)
                gt_path = os.path.join(d, f"gt_b{bi}.wav")
                if step == 0 or not os.path.exists(gt_path):
                    wav_g = vocoder.apply(vocoder_params, mels[:1])
                    save_wav(gt_path, wav_g[0, :, 0].cpu().numpy(), sample_rate)
        return {k: v / max(len(valid_batches), 1) for k, v in metrics.items()}

    valid_fn.batches = valid_batches
    return valid_fn


def make_vocoder_valid_fn(task, valid_batches: list[dict]):
    def valid_fn(state, step: int) -> dict:
        tot: dict[str, float] = {}
        with _eval_scope(task):
            for batch in valid_batches:
                gtot, gl, _ = task._gen_losses(
                    state["params_g"], state["params_d"],
                    torch.as_tensor(batch["mels"]).to(task.device),
                    torch.as_tensor(batch["wavs"]).to(task.device))
                for k, v in gl.items():
                    tot[k] = tot.get(k, 0.0) + float(v)
                tot["total"] = tot.get("total", 0.0) + float(gtot)
        m = {k: v / max(len(valid_batches), 1) for k, v in tot.items()}
        m["val_loss"] = m.get("total", 0.0)
        return m

    valid_fn.batches = valid_batches
    return valid_fn
