"""Wireless substrate of the main path (twin of ``repro/core/channel.py``).

Only the paper's model is ported: i.i.d. per-round Rayleigh fading with
per-client scale sigma_n, gains |h|^2 ~ Exponential(2 sigma_n^2) clipped to
the modulation range of :meth:`ChannelConfig.gain_bounds`. The other fading
models of the reference (rician, lognormal, gauss_markov, mobility,
outage_burst) are ROADMAP §A item 7.

A model is a draw/apply pair: ``draw(generator, n, device)`` consumes the
randomness, ``apply(raw, state, sigmas, cfg)`` is elementwise. The engine
takes its raws from a ``Draws`` source (``fl/engine.py``, whose default
calls ``draw``), so tests can replay the reference's own draws through
``apply``. :func:`draw_gains` is one round's draw and apply on a
generator.

The uplink is TDMA: a round's communication time is the sum over the
selected clients of ell / (B log2(1 + |h|^2 P / N0)) (Eq. 8,
:func:`uplink_time`; :func:`expected_uplink_time` weighs it by q).
:func:`resolve_sigmas` turns a named sigma distribution or an explicit
array into the per-client Rayleigh scales.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Static description of the wireless network (paper Section VI)."""

    n_clients: int
    bandwidth_hz: float = 22e6          # B: WiFi-like 22 MHz
    noise_power: float = 1.0            # N0 (normalized)
    p_max: float = 100.0                # peak transmit power
    p_bar: float = 1.0                  # time-average transmit power budget
    max_spectral_eff: float = 10.0      # 1024-QAM -> 10 bits/s/Hz
    min_spectral_eff: float = 0.25      # min code rate at P_max

    def gain_bounds(self) -> Tuple[float, float]:
        hi = (2.0 ** self.max_spectral_eff - 1.0) * self.noise_power / self.p_bar
        lo = (2.0 ** self.min_spectral_eff - 1.0) * self.noise_power / self.p_max
        return lo, hi


def homogeneous_sigmas(n_clients: int, sigma: float = 1.0,
                       device="cuda") -> torch.Tensor:
    """All clients share one Rayleigh scale (paper's homogeneous setup)."""
    return torch.full((n_clients,), sigma, dtype=torch.float32,
                      device=device)


def heterogeneous_sigmas(n_clients: int, fracs=(0.1, 0.4, 0.5),
                         sigmas=(0.2, 0.75, 1.2),
                         device="cuda") -> torch.Tensor:
    """Paper's heterogeneous setup: 10% sigma=.2, 40% sigma=.75, 50% 1.2."""
    counts = [int(round(f * n_clients)) for f in fracs]
    counts[-1] = n_clients - sum(counts[:-1])
    return torch.cat([torch.full((c,), s, dtype=torch.float32,
                                 device=device)
                      for c, s in zip(counts, sigmas)])


def draw_gains(generator: torch.Generator, sigmas: torch.Tensor,
               cfg: ChannelConfig) -> torch.Tensor:
    """Clipped per-client gains |h_n(t)|^2 for one round, drawn on
    ``generator`` (on ``sigmas``' device): Rayleigh(sigma) envelope, so
    |h|^2 ~ Exponential(mean 2 sigma^2)."""
    raw = _rayleigh_draw(generator, sigmas.shape[0], sigmas.device)
    return _rayleigh_apply(raw, None, sigmas, cfg)[0]


def channel_rate(gains: torch.Tensor, power: torch.Tensor,
                 cfg: ChannelConfig) -> torch.Tensor:
    """Shannon rate B log2(1 + |h|^2 P / N0) in bits/s (Eq. 8 denominator)."""
    snr = gains * power / gains.new_full((), cfg.noise_power)
    return cfg.bandwidth_hz * torch.log2(1.0 + snr)


def _per_client_time(gains, power, model_bits: float, cfg: ChannelConfig):
    """ell / max(rate, 1e-9) per client, a true IEEE division (``ell`` a
    0-d tensor: a Python numerator would become a reciprocal times it)."""
    rate = channel_rate(gains, power, cfg)
    return gains.new_full((), model_bits) / torch.clamp_min(rate, 1e-9)


def uplink_time(gains: torch.Tensor, power: torch.Tensor,
                selected: torch.Tensor, model_bits: float,
                cfg: ChannelConfig) -> torch.Tensor:
    """TDMA round communication time: the sum over the selected clients
    (a bool or {0, 1} mask over the last axis) of ell / rate."""
    per_client = _per_client_time(gains, power, model_bits, cfg)
    return torch.where(selected.bool(), per_client, 0.0).sum(-1)


def expected_uplink_time(gains: torch.Tensor, power: torch.Tensor,
                         q: torch.Tensor, model_bits: float,
                         cfg: ChannelConfig) -> torch.Tensor:
    """E[time] given selection probabilities q: the lambda-weighted term of
    y0(t)."""
    return (q * _per_client_time(gains, power, model_bits, cfg)).sum(-1)


# Named sigma distributions (Section VI's two mixes).
SIGMA_DISTS = {
    "homogeneous": homogeneous_sigmas,
    "heterogeneous": heterogeneous_sigmas,
}


def resolve_sigmas(dist, n_clients: int, device="cuda") -> torch.Tensor:
    """A named distribution ("homogeneous" | "heterogeneous") or an
    explicit (N,) array -> per-client Rayleigh scales on ``device``.

    "heterogeneous" rounds its fractions as the reference does: at
    FEMNIST's N = 3,597 that is 360/1,439/1,798 clients, not the paper's
    500/1,500/1,597, which an explicit array gives.
    """
    if isinstance(dist, str):
        if dist not in SIGMA_DISTS:
            raise ValueError(f"unknown sigma distribution {dist!r} "
                             f"(registered: {sorted(SIGMA_DISTS)})")
        return SIGMA_DISTS[dist](n_clients, device=device)
    sig = torch.as_tensor(dist, dtype=torch.float32, device=device)
    if sig.shape != (n_clients,):
        raise ValueError(f"sigma array has shape {tuple(sig.shape)}, "
                         f"want ({n_clients},)")
    return sig


def channel_state_zero(n_clients: int, device="cuda") -> torch.Tensor:
    """The reference's all-models state shape: (2, N) float32 zeros."""
    return torch.zeros((2, n_clients), dtype=torch.float32, device=device)


def _rayleigh_draw(generator: torch.Generator, n: int,
                   device) -> torch.Tensor:
    """(n,) uniforms in [1e-12, 1), the reference's ``minval``/``maxval``
    affine map followed by its ``max(minval, .)`` guard."""
    u = torch.rand((n,), generator=generator, device=device)
    return torch.clamp_min(u * (1.0 - 1e-12) + 1e-12, 1e-12)


def _rayleigh_apply(raw: torch.Tensor, state: torch.Tensor,
                    sigmas: torch.Tensor, cfg: ChannelConfig):
    """The paper's model on pre-drawn uniforms, elementwise in the client
    axis: gains = clip(-2 sigma^2 log u, lo, hi)."""
    gains = -2.0 * sigmas * sigmas * torch.log(raw)
    lo, hi = cfg.gain_bounds()
    return torch.clamp(gains, lo, hi), state


CHANNEL_RAW = {"rayleigh": (_rayleigh_draw, _rayleigh_apply)}
# The reference's fading models that this port does not have yet.
NOT_PORTED = ("rician", "lognormal", "gauss_markov", "mobility",
              "outage_burst")


class ChannelModel(NamedTuple):
    """A named fading process bound to (sigmas, cfg); its raws come from
    the run's ``Draws`` source."""

    name: str
    init: Callable[[], torch.Tensor]                       # () -> state
    apply: Callable[[torch.Tensor, torch.Tensor],
                    Tuple[torch.Tensor, torch.Tensor]]     # (raw, state)


def make_channel(name: str, sigmas: torch.Tensor,
                 cfg: ChannelConfig) -> ChannelModel:
    """Bind a fading model to (sigmas, cfg); only ``rayleigh`` exists."""
    if name not in CHANNEL_RAW:
        raise ValueError(f"unknown channel model {name!r} "
                         f"(registered: {sorted(CHANNEL_RAW)})")
    _, apply = CHANNEL_RAW[name]
    return ChannelModel(
        name=name,
        init=lambda: channel_state_zero(sigmas.shape[0], sigmas.device),
        apply=lambda raw, state: apply(raw, state, sigmas, cfg))
