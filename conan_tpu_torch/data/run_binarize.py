"""The binarize CLI (``conan_tpu/data/run_binarize.py``):

    python -m conan_tpu_torch.data.run_binarize --config <yaml> [--hparams k=v,...] \
        [--device cpu]

The config's ``binarizer_cls`` picks the binarizer (``conan`` or
``emformer``; the reference's class paths are aliases, and any other name
is ``conan``). Each mel is made by K1 on the CUDA card unless ``--device``
says otherwise. No config is saved.
"""

from __future__ import annotations

import argparse
import logging
import sys

from conan_tpu_torch.config import set_hparams
from conan_tpu_torch.data.binarizer import ConanBinarizer, EmformerBinarizer

BINARIZER_ALIASES = {
    "data_gen.conan_binarizer.ConanBinarizer": "conan",
    "data_gen.conan_binarizer.EmformerBinarizer": "emformer",
    "conan": "conan", "emformer": "emformer",
}
BINARIZERS = {"conan": ConanBinarizer, "emformer": EmformerBinarizer}


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    argv = list(argv if argv is not None else sys.argv[1:])
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    device = ap.parse_known_args(argv)[0].device
    hp = set_hparams(argv=argv, save=False)
    kind = BINARIZER_ALIASES.get(hp.get("binarizer_cls", "conan"), "conan")
    BINARIZERS[kind](hp, device=device).process()


if __name__ == "__main__":
    main()
