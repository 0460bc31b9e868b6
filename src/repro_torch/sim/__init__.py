"""IoT substrate: device-fleet tables, availability, the simulated clock
and fleet+data scenarios (``independent``)."""
from repro_torch.sim.availability import (AVAILABILITY_STREAM,
                                          AvailabilityDraws,
                                          AvailabilityState,
                                          draw_availability, effective_p,
                                          init_availability, sample_mask)
from repro_torch.sim.clock import (device_event_energy, device_round_time,
                                   round_stats, staleness_weights)
from repro_torch.sim.devices import (DeviceFleet, SimConfig,
                                     available_fleets, make_fleet,
                                     register_fleet)
from repro_torch.sim.scenarios import (Scenario, available_scenarios,
                                       make_scenario)
