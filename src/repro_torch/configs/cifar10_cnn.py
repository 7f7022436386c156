"""Paper Section VI-A experiment: CIFAR-10, i.i.d., N = 100 clients (twin of
``repro/configs/cifar10_cnn.py``).

Minibatch 32, gamma = 0.01, I = 10, B = 22 MHz, Pbar = 1, Pmax = 100,
N0 = 1, ell = 32 d with d = 555,178, V = 1000, lambda in {10, 100}; the CNN
has 32/64 conv channels and a 120-wide hidden layer on 32x32x3 images with
10 classes. The data are synthetic (``data/synthetic.py``).
"""

import dataclasses

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.models.cnn import CNNConfig


@dataclasses.dataclass(frozen=True)
class PaperExperiment:
    name: str
    n_clients: int
    cnn: CNNConfig
    d_paper: int                 # paper's parameter count (sets ell = 32 d)
    gamma: float = 0.01
    local_steps: int = 10
    batch: int = 32
    V: float = 1000.0

    def channel(self) -> ChannelConfig:
        return ChannelConfig(n_clients=self.n_clients, bandwidth_hz=22e6,
                             noise_power=1.0, p_max=100.0, p_bar=1.0)

    def scheduler(self, lam: float) -> SchedulerConfig:
        return SchedulerConfig(n_clients=self.n_clients,
                               model_bits=32.0 * self.d_paper,
                               lam=lam, V=self.V)


CONFIG = PaperExperiment(
    name="cifar10",
    n_clients=100,
    cnn=CNNConfig(height=32, width=32, channels=3, n_classes=10),
    d_paper=555_178,
)
