"""Serving example: batched prefill + decode on a reduced mamba2 (SSM
state, O(1) per token) and a reduced mixtral (MoE and the sliding-window
rolling cache) (twin of the reference's ``examples/serve_mamba.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_mamba [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    common = ["--batch", "2", "--prompt-len", "32", "--gen", "16",
              "--device", args.device]
    print("== mamba2-130m (reduced): recurrent SSM decode ==")
    serve_main(["--arch", "mamba2-130m", *common])
    print("\n== mixtral-8x22b (reduced): MoE + sliding-window cache ==")
    serve_main(["--arch", "mixtral-8x22b", *common])


if __name__ == "__main__":
    main()
