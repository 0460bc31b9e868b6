"""repro_torch.core — the paper's contribution: weight-driven coalition
dynamics, in PyTorch.

Public API:
  distance.pairwise_dists / sq_dists_to_points   (§III.A)
  barycenter.barycenters / medoids               (§III.B, Step III)
  coalitions.init_centers / run_round            (Algorithm 1)
  backends.register_backend / get_backend        (stream | dot | cuda)
  fused.fused_round                              (two-pass streaming round)
  instrument.count_w_passes                      (W-pass accounting)
  strategies.register_strategy / make_strategy   (aggregation rules)
  client.client_update / local_phase             (local phase)
  server.Federation                              (round loop)
"""
from repro_torch.core import (backends, barycenter, client, coalitions,
                              distance, fused, instrument, pytree, server,
                              strategies)

__all__ = ["backends", "barycenter", "client", "coalitions", "distance",
           "fused", "instrument", "pytree", "server", "strategies"]
