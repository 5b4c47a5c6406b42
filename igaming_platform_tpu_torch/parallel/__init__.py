"""Parallelism over a logical mesh of devices: mesh, collectives, shardings,
routed experts, slot-sharded state and the multi-process bootstrap."""
