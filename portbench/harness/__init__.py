"""The harness's shared code: the specification's loader, the traffic
generator, the yardstick (peaks, operations and bytes), the profile
reduction and the comparison's bookkeeping."""
