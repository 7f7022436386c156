"""Paper core: the wireless channel and its fading models, Lambert-W, the
Algorithm-2 scheduler, the policy registry and the Corollary-1 bound."""

from repro_torch.core.bound import (BoundAccumulator, BoundConstants,
                                    accumulate, corollary1_bound,
                                    init_accumulator,
                                    sampling_term_per_round)
from repro_torch.core.channel import (CHANNEL_IDS, CHANNEL_MODELS,
                                      SIGMA_DISTS, ChannelConfig,
                                      ChannelModel, channel_rate,
                                      channel_state_zero, draw_gains,
                                      expected_uplink_time,
                                      heterogeneous_sigmas,
                                      homogeneous_sigmas, make_channel,
                                      mobility_rho, resolve_sigmas,
                                      uplink_time)
from repro_torch.core.lambertw import lambertw0
from repro_torch.core.policies import (POLICIES, POLICY_IDS, PolicyState,
                                       greedy_channel, init_policy_state,
                                       make_policy, policy_aux_init,
                                       proportional_gain)
from repro_torch.core.scheduler import (SchedulerConfig, SchedulerState,
                                        SolveCoeffs, estimate_avg_selected,
                                        init_state, sample_selection,
                                        schedule_step, solve_candidates,
                                        solve_coeffs, solve_round,
                                        solve_round_coeffs,
                                        uniform_selection, update_queues, y0)

__all__ = ["BoundAccumulator", "BoundConstants", "accumulate",
           "corollary1_bound", "init_accumulator", "sampling_term_per_round",
           "CHANNEL_IDS", "CHANNEL_MODELS", "SIGMA_DISTS", "ChannelConfig",
           "ChannelModel", "channel_rate", "channel_state_zero",
           "draw_gains", "expected_uplink_time", "heterogeneous_sigmas",
           "homogeneous_sigmas", "make_channel", "mobility_rho",
           "resolve_sigmas", "uplink_time", "lambertw0", "POLICIES",
           "POLICY_IDS", "PolicyState", "greedy_channel",
           "init_policy_state", "make_policy", "policy_aux_init",
           "proportional_gain", "SchedulerConfig", "SchedulerState",
           "SolveCoeffs", "estimate_avg_selected", "init_state",
           "sample_selection", "schedule_step", "solve_candidates",
           "solve_coeffs", "solve_round", "solve_round_coeffs",
           "uniform_selection", "update_queues", "y0"]
