"""Paper core: wireless channel, Lambert-W, the Algorithm-2 scheduler, and
the ported policies (proposed, uniform, greedy_channel)."""

from repro_torch.core.channel import (ChannelConfig, channel_rate,
                                      heterogeneous_sigmas,
                                      homogeneous_sigmas, make_channel)
from repro_torch.core.lambertw import lambertw0
from repro_torch.core.policies import (PolicyState, init_policy_state,
                                       make_policy)
from repro_torch.core.scheduler import (SchedulerConfig, SolveCoeffs,
                                        estimate_avg_selected, solve_coeffs,
                                        solve_round, solve_round_coeffs)

__all__ = ["ChannelConfig", "channel_rate", "heterogeneous_sigmas",
           "homogeneous_sigmas", "make_channel", "lambertw0", "PolicyState",
           "init_policy_state", "make_policy", "SchedulerConfig",
           "SolveCoeffs", "estimate_avg_selected", "solve_coeffs",
           "solve_round", "solve_round_coeffs"]
