"""Wireless substrate: the fading-model registry and the TDMA uplink time
model (twin of ``repro/core/channel.py``).

Six fading models, the reference's, in its registry order:

* ``rayleigh`` (the paper's) — i.i.d. per-round Rayleigh envelope with
  per-client scale sigma_n, gains |h|^2 ~ Exponential(2 sigma_n^2);
* ``rician`` — a line-of-sight component with K-factor ``k_factor``;
  K -> 0 is Rayleigh;
* ``lognormal`` — Rayleigh fast fading times mean-normalised log-normal
  shadowing of ``shadow_db`` dB;
* ``gauss_markov`` — the complex AR(1) field g(t) = rho g(t-1) +
  sqrt(1 - rho^2) w(t); rho = 0 is i.i.d. Rayleigh;
* ``mobility`` — ``gauss_markov`` at the rho of :func:`mobility_rho`
  (speed, carrier, round period);
* ``outage_burst`` — Rayleigh gated by a Gilbert-Elliott outage chain
  (stationary probability ``outage_p``, mean burst ``burst_len`` rounds);
  an outage pins the gain to the modulation clip floor.

Every gain is clipped to the modulation range of
:meth:`ChannelConfig.gain_bounds`. A model's state is a (2, N) float32
tensor (the I/Q field, the outage indicator, or zeros); the sweep carries
(2, S, N), one row per seed, which broadcasts against the (N,) sigmas.

A model is three pieces over pre-drawn randomness: ``draw(generator, n,
device)`` consumes it (``CHANNEL_RAW``), ``apply(raw, state, sigmas, cfg,
**params)`` is elementwise, and ``init(raw, sigmas, cfg, **params)``
builds the round-0 state from the raw of ``CHANNEL_INIT_RAW`` (None for
the memoryless models). The raws are the reference's shapes: (N,)
uniforms in [1e-12, 1) for rayleigh, (2, N) normals for rician,
gauss_markov and mobility, (uniforms, normals) for lognormal,
(uniforms, uniforms in [0, 1)) for outage_burst; at init, (2, N) normals
for gauss_markov and mobility and (N,) uniforms for outage_burst. The
engines take their raws from a ``Draws`` source (``fl/engine.py``), so
tests replay the reference's own draws through ``apply`` and ``init``.

Scalars keep the reference's float32 arithmetic: a Python parameter is
rounded once to float32 as JAX does with a weakly typed scalar, and every
division by one is a true IEEE division by a 0-d tensor on the lanes'
device.

The uplink is TDMA: a round's communication time is the sum over the
selected clients of ell / (B log2(1 + |h|^2 P / N0)) (Eq. 8,
:func:`uplink_time`; :func:`expected_uplink_time` weighs it by q).
:func:`resolve_sigmas` turns a named sigma distribution or an explicit
array into the per-client Rayleigh scales.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
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
    """The all-models state shape: (2, N) float32 zeros."""
    return torch.zeros((2, n_clients), dtype=torch.float32, device=device)


def _f32(x: float) -> float:
    """A Python float rounded to the nearest float32, as JAX rounds a
    weakly typed scalar against a float32 operand."""
    return float(np.float32(x))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float32 as a 0-d tensor on ``like``'s device (a
    division by it is a true IEEE division on every device)."""
    return like.new_full((), _f32(x), dtype=torch.float32)


def _clip_gains(gains: torch.Tensor, cfg: ChannelConfig) -> torch.Tensor:
    lo, hi = cfg.gain_bounds()
    return torch.clamp(gains, lo, hi)


def _fast_fading(u: torch.Tensor, sigmas: torch.Tensor,
                 cfg: ChannelConfig) -> torch.Tensor:
    """The paper's clipped Rayleigh gain -2 sigma^2 log u."""
    return _clip_gains(-2.0 * sigmas * sigmas * torch.log(u), cfg)


def _uniform_open(generator: torch.Generator, n: int, device):
    """(n,) uniforms in [1e-12, 1): the reference's ``minval``/``maxval``
    affine map followed by its ``max(minval, .)`` guard."""
    u = torch.rand((n,), generator=generator, device=device)
    return torch.clamp_min(u * (1.0 - 1e-12) + 1e-12, 1e-12)


def _uniform(generator: torch.Generator, n: int, device):
    """(n,) uniforms in [0, 1)."""
    return torch.rand((n,), generator=generator, device=device)


def _normal2(generator: torch.Generator, n: int, device):
    """(2, n) standard normals (the I/Q pair)."""
    return torch.randn((2, n), generator=generator, device=device)


def _zero_init(raw, sigmas: torch.Tensor, cfg: ChannelConfig, **params):
    """A memoryless model's state: zeros, no randomness."""
    return channel_state_zero(sigmas.shape[0], sigmas.device)


_rayleigh_draw = _uniform_open


def _rayleigh_apply(raw: torch.Tensor, state: torch.Tensor,
                    sigmas: torch.Tensor, cfg: ChannelConfig):
    """The paper's model on pre-drawn uniforms, elementwise in the client
    axis: gains = clip(-2 sigma^2 log u, lo, hi)."""
    return _fast_fading(raw, sigmas, cfg), state


_rician_draw = _normal2


def _rician_apply(xy, state, sigmas, cfg, k_factor=5.0):
    """Rician fading: LOS amplitude nu = sigma sqrt(2K / (K + 1)) plus a
    complex scatter of per-component std s = sigma / sqrt(K + 1), so
    E[|h|^2] = 2 sigma^2; K -> 0 gives sigma^2 (x^2 + y^2), Rayleigh."""
    k = _scalar(k_factor, sigmas)
    nu = sigmas * torch.sqrt(2.0 * k / (k + 1.0))
    s = sigmas / torch.sqrt(k + 1.0)
    re = nu + s * xy[0]
    im = s * xy[1]
    return _clip_gains(re * re + im * im, cfg), state


def _lognormal_draw(generator, n, device):
    """(uniforms in [1e-12, 1), standard normals), each (n,)."""
    return (_uniform_open(generator, n, device),
            torch.randn((n,), generator=generator, device=device))


def _lognormal_apply(raw, state, sigmas, cfg, shadow_db=4.0):
    """Rayleigh fast fading times the shadowing factor
    10^(shadow_db X / 10) over its mean exp(beta^2 / 2), beta =
    shadow_db ln10 / 10, so E[|h|^2] stays 2 sigma^2."""
    u, x = raw
    beta = float(shadow_db) * math.log(10.0) / 10.0
    shadow = torch.exp(_f32(beta) * x - _f32(0.5 * beta * beta))
    return _clip_gains(_fast_fading(u, sigmas, cfg) * shadow, cfg), state


def _gauss_markov_init(xy, sigmas, cfg, rho=0.9):
    """Stationary start: g(0) ~ CN(0, 2 sigma^2) per client."""
    return sigmas * xy


_gauss_markov_draw = _normal2


def _gauss_markov_apply(xy, state, sigmas, cfg, rho=0.9):
    """Complex AR(1) field g(t) = rho g(t-1) + sqrt(1 - rho^2) w(t), w ~
    CN(0, 2 sigma^2): the gain stays Exponential(2 sigma^2) while the
    power decorrelates as rho^(2 lag)."""
    r = _scalar(rho, sigmas)
    new = r * state + torch.sqrt(1.0 - r * r) * (sigmas * xy)
    return _clip_gains(new[0] * new[0] + new[1] * new[1], cfg), new


_LIGHT_SPEED_MPS = 299_792_458.0


def mobility_rho(speed_mps: float = 1.5, carrier_hz: float = 2.4e9,
                 round_s: float = 0.01) -> float:
    """AR(1) coefficient implied by terminal mobility: the Gaussian
    Doppler autocorrelation exp(-2 (pi f_D T)^2) over one round T, f_D =
    v f_c / c. Pedestrian defaults give rho ~ 0.75; v = 0 gives 1."""
    f_d = float(speed_mps) * float(carrier_hz) / _LIGHT_SPEED_MPS
    return math.exp(-2.0 * (math.pi * f_d * float(round_s)) ** 2)


def _mobility_init(xy, sigmas, cfg, speed_mps=1.5, carrier_hz=2.4e9,
                   round_s=0.01):
    return _gauss_markov_init(xy, sigmas, cfg,
                              rho=mobility_rho(speed_mps, carrier_hz,
                                               round_s))


_mobility_draw = _normal2


def _mobility_apply(xy, state, sigmas, cfg, speed_mps=1.5, carrier_hz=2.4e9,
                    round_s=0.01):
    """:func:`_gauss_markov_apply` at the rho of :func:`mobility_rho`."""
    return _gauss_markov_apply(xy, state, sigmas, cfg,
                               rho=mobility_rho(speed_mps, carrier_hz,
                                                round_s))


def _outage_burst_rates(outage_p, burst_len):
    """Gilbert-Elliott transition probabilities (p_enter, p_recover):
    p_recover = 1 / burst_len, and p_enter makes the stationary outage
    mass p_enter / (p_enter + p_recover) exactly ``outage_p``."""
    p = float(outage_p)
    ln = float(burst_len)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"outage_p={p} must be in [0, 1)")
    if ln < 1.0:
        raise ValueError(f"burst_len={ln} must be >= 1 round")
    p_recover = 1.0 / ln
    p_enter = p * p_recover / (1.0 - p)
    if p_enter > 1.0:
        raise ValueError(
            f"outage_p={p} with burst_len={ln} needs a good->bad "
            f"probability {p_enter:.3f} > 1; keep outage_p <= "
            f"burst_len / (1 + burst_len)")
    return p_enter, p_recover


def _outage_gain_floor(cfg: ChannelConfig) -> float:
    """The in-outage gain: the modulation clip floor rounded UP to the
    next float32, so it never compares below ``gain_bounds()[0]``."""
    lo, _ = cfg.gain_bounds()
    f = np.float32(lo)
    if float(f) < lo:
        f = np.nextafter(f, np.float32(np.inf))
    return float(f)


def _outage_burst_init(u, sigmas, cfg, outage_p=0.1, burst_len=5.0):
    """Stationary start: a client begins in outage w.p. ``outage_p``.
    Row 0 of the state is the {0, 1} outage indicator, row 1 zeros."""
    _outage_burst_rates(outage_p, burst_len)
    bad = (u < _f32(outage_p)).to(torch.float32)
    return torch.stack([bad, torch.zeros_like(bad)])


def _outage_burst_draw(generator, n, device):
    """(fast-fading uniforms in [1e-12, 1), transition uniforms in
    [0, 1)), each (n,)."""
    return (_uniform_open(generator, n, device),
            _uniform(generator, n, device))


def _outage_burst_apply(raw, state, sigmas, cfg, outage_p=0.1,
                        burst_len=5.0):
    """Two-state Markov outage gate over Rayleigh fast fading: a good
    client enters an outage w.p. p_enter, an outage ends w.p. p_recover;
    in outage the gain is the clip floor (a deep fade, never a hole)."""
    u, v = raw
    p_enter, p_recover = _outage_burst_rates(outage_p, burst_len)
    new_bad = torch.where(state[0] > 0.5, v >= _f32(p_recover),
                          v < _f32(p_enter))
    gains = torch.where(new_bad, _outage_gain_floor(cfg),
                        _fast_fading(u, sigmas, cfg))
    return gains, torch.stack([new_bad.to(torch.float32),
                               torch.zeros_like(state[1])])


# name -> (draw, apply): the randomness a round consumes and the
# elementwise step on it.
CHANNEL_RAW = {
    "rayleigh": (_rayleigh_draw, _rayleigh_apply),
    "rician": (_rician_draw, _rician_apply),
    "lognormal": (_lognormal_draw, _lognormal_apply),
    "gauss_markov": (_gauss_markov_draw, _gauss_markov_apply),
    "mobility": (_mobility_draw, _mobility_apply),
    "outage_burst": (_outage_burst_draw, _outage_burst_apply),
}
# name -> the round-0 state's raw draw, None for the memoryless models
CHANNEL_INIT_RAW = {"rayleigh": None, "rician": None, "lognormal": None,
                    "gauss_markov": _normal2, "mobility": _normal2,
                    "outage_burst": _uniform}
# name -> the keyword parameters of its init and apply
CHANNEL_PARAMS = {"rayleigh": (), "rician": ("k_factor",),
                  "lognormal": ("shadow_db",), "gauss_markov": ("rho",),
                  "mobility": ("speed_mps", "carrier_hz", "round_s"),
                  "outage_burst": ("outage_p", "burst_len")}


def _step(draw, apply):
    def step(generator, state, sigmas, cfg, **params):
        raw = draw(generator, sigmas.shape[0], sigmas.device)
        return apply(raw, state, sigmas, cfg, **params)
    return step


# name -> (init, step): ``init(raw, sigmas, cfg, **params) -> state`` on
# the init raw, ``step(generator, state, sigmas, cfg, **params) ->
# (gains, state)`` drawing on a generator.
CHANNEL_MODELS = {
    "rayleigh": (_zero_init, _step(*CHANNEL_RAW["rayleigh"])),
    "rician": (_zero_init, _step(*CHANNEL_RAW["rician"])),
    "lognormal": (_zero_init, _step(*CHANNEL_RAW["lognormal"])),
    "gauss_markov": (_gauss_markov_init,
                     _step(*CHANNEL_RAW["gauss_markov"])),
    "mobility": (_mobility_init, _step(*CHANNEL_RAW["mobility"])),
    "outage_burst": (_outage_burst_init,
                     _step(*CHANNEL_RAW["outage_burst"])),
}

# Stable ids in the registry's order, as the reference's.
CHANNEL_IDS = {name: i for i, name in enumerate(CHANNEL_MODELS)}


class ChannelModel(NamedTuple):
    """A named fading process bound to (sigmas, cfg, params)."""

    name: str
    init: Callable                     # init raw (or None) -> state
    apply: Callable                    # (raw, state) -> (gains, state)
    draw: Callable                     # generator -> a round's raw
    draw_init: Callable                # generator -> the init raw or None
    step: Callable                     # (generator, state) -> (gains, state)


def check_channel(name: str, params=()) -> dict:
    """``params`` ((name, value) pairs or a dict) of a registered model,
    as a dict; unknown models and parameters raise ``ValueError``."""
    if name not in CHANNEL_MODELS:
        raise ValueError(f"unknown channel model {name!r} "
                         f"(registered: {sorted(CHANNEL_MODELS)})")
    params = dict(params)
    bad = sorted(set(params) - set(CHANNEL_PARAMS[name]))
    if bad:
        raise ValueError(f"channel {name!r} takes no channel_params {bad} "
                         f"(its params: {list(CHANNEL_PARAMS[name])})")
    return params


def make_channel(name: str, sigmas: torch.Tensor, cfg: ChannelConfig,
                 **params) -> ChannelModel:
    """Bind a registered fading model to (sigmas, cfg) and its params
    (``k_factor``, ``shadow_db``, ``rho``, ``speed_mps`` / ``carrier_hz`` /
    ``round_s``, ``outage_p`` / ``burst_len``); draws land on sigmas'
    device."""
    params = check_channel(name, params)
    init_fn, step_fn = CHANNEL_MODELS[name]
    draw, apply = CHANNEL_RAW[name]
    draw_init = CHANNEL_INIT_RAW[name]
    n, device = sigmas.shape[0], sigmas.device
    return ChannelModel(
        name=name,
        init=lambda raw=None: init_fn(raw, sigmas, cfg, **params),
        apply=lambda raw, state: apply(raw, state, sigmas, cfg, **params),
        draw=lambda generator: draw(generator, n, device),
        draw_init=lambda generator: (None if draw_init is None
                                     else draw_init(generator, n, device)),
        step=lambda generator, state: step_fn(generator, state, sigmas, cfg,
                                              **params))
