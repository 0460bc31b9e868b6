"""IoT substrate: device-fleet tables, availability, the simulated clock
and energy ledger, fleet+data scenarios, cohort sampling and byzantine
attacks."""
from repro_torch.sim.attacks import (ATTACK_STREAM, Attack, adversary_mask,
                                     available_attacks, make_attack,
                                     register_attack)
from repro_torch.sim.availability import (AVAILABILITY_STREAM,
                                          AvailabilityDraws,
                                          AvailabilityState,
                                          draw_availability, effective_p,
                                          init_availability, sample_mask)
from repro_torch.sim.clock import (device_event_energy, device_round_time,
                                   round_stats, staleness_weights)
from repro_torch.sim.cohort import (COHORT_STREAM, DEFAULT_CELL,
                                    sample_cohort, sample_cohorts)
from repro_torch.sim.devices import (DeviceFleet, SimConfig,
                                     available_fleets, make_fleet,
                                     register_fleet)
from repro_torch.sim.scenarios import (Scenario, available_scenarios,
                                       capability_rank, label_skew_rank,
                                       make_scenario, quantity_rank,
                                       register_scenario)
