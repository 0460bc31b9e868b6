"""Device-fleet tables and fleet+data scenarios (``ideal``/``independent``)."""
from repro_torch.sim.devices import DeviceFleet, available_fleets, make_fleet
from repro_torch.sim.scenarios import (Scenario, available_scenarios,
                                       make_scenario)
