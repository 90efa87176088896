"""Per-mel-bin spec_min / spec_max over the training split
(``conan_tpu/data/spec_stats.py``): the dataset statistics the mel postnet
normalizes with.

    python -m conan_tpu_torch.data.spec_stats --config egs/conan_postnet.yaml \
        [--hparams binary_data_dir=...]

writes ``<binary_data_dir>/spec_stats.npz`` (read by the postnet's
``build_task`` where the config has ``spec_min: null``) and prints YAML lists
to paste into a config.
"""

from __future__ import annotations

import sys

import numpy as np
import yaml

from conan_tpu_torch.config import set_hparams
from conan_tpu_torch.data.record_store import RecordReader


def compute(data_path: str, n_mels: int = 80) -> tuple[np.ndarray, np.ndarray]:
    """(min, max) over every frame of every record's ``mel`` [T, n_mels] in
    the record store at ``data_path``, per bin, float64."""
    r = RecordReader(data_path)
    lo = np.full(n_mels, np.inf)
    hi = np.full(n_mels, -np.inf)
    for i in range(len(r)):
        mel = np.asarray(r[i]["mel"])
        lo = np.minimum(lo, mel.min(axis=0))
        hi = np.maximum(hi, mel.max(axis=0))
    return lo, hi


def main(argv=None) -> None:
    hp = set_hparams(argv=argv if argv is not None else sys.argv[1:], save=False)
    lo, hi = compute(f"{hp['binary_data_dir']}/train", hp.get("audio_num_mel_bins", 80))
    np.savez(f"{hp['binary_data_dir']}/spec_stats.npz", spec_min=lo, spec_max=hi)
    print(yaml.safe_dump({"spec_min": [round(float(x), 6) for x in lo],
                          "spec_max": [round(float(x), 6) for x in hi]}))


if __name__ == "__main__":
    main()
