"""The offline F0 extraction CLI (``conan_tpu/data/extract_f0.py``):

    python -m conan_tpu_torch.data.extract_f0 --config <yaml> --rmvpe_ckpt rmvpe.pt \
        [--hparams k=v,...] [--device cpu]

For each item of ``<processed_data_dir>/metadata.json`` it runs RMVPE on the
item's wav and saves the curve at the config's hop as
``<wav dir>_f0/<name>_f0.npy`` (float32, ``len(wav) // hop_size + 1``
frames), where ``ConanBinarizer`` reads it; an existing file is skipped.
The network runs on the CUDA card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from conan_tpu_torch.config import set_hparams
from conan_tpu_torch.data.binarizer import f0_path, load_wav
from conan_tpu_torch.models.rmvpe import RMVPE

log = logging.getLogger(__name__)


def main(argv=None) -> int:
    """Returns the number of files written."""
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--rmvpe_ckpt", required=True)
    ap.add_argument("--hparams", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args, _ = ap.parse_known_args(argv)
    hp = set_hparams(config=args.config, hparams_str=args.hparams, save=False)
    rmvpe = RMVPE.from_torch_checkpoint(args.rmvpe_ckpt, device=args.device)
    with open(os.path.join(hp["processed_data_dir"], "metadata.json")) as f:
        items = json.load(f)
    sr, hop = hp["audio_sample_rate"], hp["hop_size"]
    done = 0
    for item in items:
        out_path = f0_path(item["wav_fn"])
        if os.path.exists(out_path):
            continue
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        wav = load_wav(item["wav_fn"], sr)
        f0, _uv = rmvpe.get_pitch(wav, sr, hop, len(wav) // hop + 1)
        np.save(out_path, f0.astype(np.float32))
        done += 1
        if done % 100 == 0:
            log.info("extracted %d", done)
    log.info("done: %d new f0 files", done)
    return done


if __name__ == "__main__":
    main()
