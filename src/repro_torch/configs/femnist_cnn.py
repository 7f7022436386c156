"""Paper Section VI-B experiment: FEMNIST, non-i.i.d. by writer, N = 3,597
(twin of ``repro/configs/femnist_cnn.py``).

Constants per the paper: d = 444,062 (ell = 32 d), the CIFAR-10 CNN family
(32/64/120) on 28x28x1 images with 62 classes, the same channel and
scheduler constants. The paper's heterogeneous channels put 500/1,500/1,597
clients at sigma 0.2/0.75/1.2: pass that split to
``core/channel.py::resolve_sigmas`` as an explicit array
(:func:`paper_sigmas`); the named "heterogeneous" distribution rounds the
fractions 0.1/0.4/0.5 to 360/1,439/1,798 at this N, as the reference's
does. The synthetic stand-in keeps one writer per client
(``data/synthetic.py::make_femnist_like``).

``scaled(frac)`` shrinks the client count in proportion (same constants).
"""

import dataclasses

import numpy as np

from repro_torch.configs.cifar10_cnn import PaperExperiment
from repro_torch.models.cnn import CNNConfig

CONFIG = PaperExperiment(
    name="femnist",
    n_clients=3597,
    cnn=CNNConfig(height=28, width=28, channels=1, n_classes=62),
    d_paper=444_062,
)

# the paper's split of the 3,597 writers over sigma 0.2 / 0.75 / 1.2
PAPER_SIGMA_COUNTS = (500, 1500, 1597)
PAPER_SIGMAS = (0.2, 0.75, 1.2)


def scaled(frac: float) -> PaperExperiment:
    return dataclasses.replace(CONFIG,
                               n_clients=max(10, int(CONFIG.n_clients * frac)))


def paper_sigmas() -> np.ndarray:
    """The paper's 500/1,500/1,597 per-client sigmas as a host (3597,)
    float32 array, for ``resolve_sigmas(paper_sigmas(), 3597)``."""
    return np.repeat(np.float32(PAPER_SIGMAS), PAPER_SIGMA_COUNTS)
