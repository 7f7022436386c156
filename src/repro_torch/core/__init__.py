"""Paper core: wireless channel, Lambert-W, the Algorithm-2 scheduler, the
ported policies (proposed, uniform, greedy_channel) and the Corollary-1
bound."""

from repro_torch.core.bound import (BoundAccumulator, BoundConstants,
                                    accumulate, corollary1_bound,
                                    init_accumulator,
                                    sampling_term_per_round)
from repro_torch.core.channel import (SIGMA_DISTS, ChannelConfig,
                                      channel_rate, draw_gains,
                                      expected_uplink_time,
                                      heterogeneous_sigmas,
                                      homogeneous_sigmas, make_channel,
                                      resolve_sigmas, uplink_time)
from repro_torch.core.lambertw import lambertw0
from repro_torch.core.policies import (PolicyState, init_policy_state,
                                       make_policy)
from repro_torch.core.scheduler import (SchedulerConfig, SchedulerState,
                                        SolveCoeffs, estimate_avg_selected,
                                        init_state, sample_selection,
                                        schedule_step, solve_candidates,
                                        solve_coeffs, solve_round,
                                        solve_round_coeffs,
                                        uniform_selection, update_queues, y0)

__all__ = ["BoundAccumulator", "BoundConstants", "accumulate",
           "corollary1_bound", "init_accumulator", "sampling_term_per_round",
           "SIGMA_DISTS", "ChannelConfig", "channel_rate", "draw_gains",
           "expected_uplink_time", "heterogeneous_sigmas",
           "homogeneous_sigmas", "make_channel", "resolve_sigmas",
           "uplink_time", "lambertw0", "PolicyState", "init_policy_state",
           "make_policy", "SchedulerConfig", "SchedulerState", "SolveCoeffs",
           "estimate_avg_selected", "init_state", "sample_selection",
           "schedule_step", "solve_candidates", "solve_coeffs",
           "solve_round", "solve_round_coeffs", "uniform_selection",
           "update_queues", "y0"]
