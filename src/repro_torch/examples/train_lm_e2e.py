"""End-to-end LM training example (twin of the reference's
``examples/train_lm_e2e.py``): trains a reduced mamba2 on the synthetic
token stream for a few hundred steps and checkpoints it, through the
``launch/train.py`` CLI.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e \\
        [--device cpu] [--steps 200]

The reference's defaults: 4 layers of d_model 256 (~9M parameters), 200
SGD steps of batch 8 x 128 tokens at gamma 0.05; pass ``--d-model 768
--layers 24`` for the full 130M config. The checkpoint goes to
``out/mamba2_e2e.npz`` unless ``--checkpoint`` says otherwise. Runs on
the card (K4 and its backward kernel in every Mamba layer) unless
``--device cpu`` is given; any other argument goes to ``launch/train.py``
(a later one wins).
"""

from __future__ import annotations

import sys

from repro_torch.launch.train import main as train_main

DEFAULTS = ["--arch", "mamba2-130m", "--steps", "200", "--seq", "128",
            "--batch", "8", "--layers", "4", "--d-model", "256",
            "--gamma", "0.05", "--checkpoint", "out/mamba2_e2e.npz"]


def main(argv=None):
    args = DEFAULTS + list(sys.argv[1:] if argv is None else argv)
    return train_main(args)


if __name__ == "__main__":
    main()
